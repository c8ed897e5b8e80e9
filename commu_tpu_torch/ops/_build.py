"""Build, load and launch the package's hand-written CUDA kernels.

``commu_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``commu_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags (a changed source rebuilds; an unchanged one loads the file left by an
earlier process).  Each source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects.  The library is loaded with ``ctypes``: pointers and the
stream travel as ``c_void_p``, and every C entry point returns
``cudaGetLastError()`` after its launch, which ``launch`` turns into an
exception.

Nothing here runs at import time: a CPU-only installation imports every
module of the package and never calls ``library()``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else
LAUNCHES = {"rel_attention_fwd": 0, "ffn_block_fwd": 0, "cache_append": 0,
            "project_mem_kv": 0, "rel_attention_mem_fwd": 0,
            "ring_write_layer": 0, "nll_fwd": 0, "rel_attention_mem_bwd": 0,
            "ffn_block_bwd": 0, "nll_bwd": 0, "embed_grad": 0,
            "dropout_bdt": 0, "rel_attention_bwd": 0,
            "rel_attention_proj_fwd": 0, "ffn_block_fused_o_fwd": 0,
            "ffn_block_fused_o_bwd": 0, "ring_write": 0}
# the reference's fast numerics are branches of the same sources, counted
# apart: "[int8]" is an attention kernel's int8 BD (forward) or int8 dphi
# (backward) form, whatever its masks' width; "[bits8]" a kernel that drew
# its masks at 8 bits and has no int8 product
LAUNCHES.update({f"{name}[int8]": 0 for name in (
    "rel_attention_fwd", "rel_attention_mem_fwd", "rel_attention_bwd",
    "rel_attention_mem_bwd")})
LAUNCHES.update({f"{name}[bits8]": 0 for name in (
    "rel_attention_fwd", "rel_attention_mem_fwd", "rel_attention_bwd",
    "rel_attention_mem_bwd", "rel_attention_proj_fwd", "ffn_block_fwd",
    "ffn_block_bwd", "ffn_block_fused_o_fwd", "ffn_block_fused_o_bwd",
    "dropout_bdt")})
# a wrapper's count where it differs from the C entry point it calls: the
# fuse_o form of the FFN kernels is a branch of their sources
_ENTRY = {"ffn_block_fused_o_fwd": "ffn_block_fwd",
          "ffn_block_fused_o_bwd": "ffn_block_bwd"}
# seconds the nvcc build took in this process (None: loaded an earlier build)
build_seconds = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# a kernel's dropout arguments: seed, threshold (0: off), keep-scale and the
# draw width in bits (prng.kernel_args)
_DROP = [_I, _I, _F, _I]
_SIGNATURES = {
    "commu_rel_attention_fwd": [_I] + [_P] * 14 + [_I] * 5 + [_F] + _DROP + [_P],
    "commu_ffn_block_fwd": [_I] + [_P] * 17 + [_I] * 5 + _DROP + [_P],
    "commu_cache_append": [_I] + [_P] * 6 + [_I] * 4 + [_P],
    "commu_project_mem_kv": [_I] + [_P] * 6 + [_I] * 6 + [_P],
    "commu_rel_attention_mem_fwd": [_I] + [_P] * 16 + [_I] * 7 + [_F] + _DROP
    + [_P],
    "commu_ring_write_layer": [_I] + [_P] * 2 + [_I] * 4 + [_P],
    "commu_nll_fwd": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    "commu_rel_attention_mem_bwd": [_I] + [_P] * 25 + [_I] * 9 + [_F] + _DROP
    + [_P],
    "commu_ffn_block_bwd": [_I] + [_P] * 25 + [_I] * 5 + _DROP + [_P],
    "commu_nll_bwd": [_I] + [_P] * 10 + [_I] * 4 + [_P],
    "commu_embed_grad": [_I] + [_P] * 4 + [_I] * 4 + [_F, _P],
    "commu_dropout_bdt": [_I] + [_P] * 2 + [_I] + _DROP + [_I] * 3 + [_P],
    "commu_rel_attention_bwd": [_I] + [_P] * 20 + [_I] * 5 + [_F] + _DROP
    + [_P],
    "commu_rel_attention_proj_fwd": [_I] + [_P] * 19 + [_I] * 9 + [_F] + _DROP
    + [_P],
    "commu_ring_write": [_I, _P, _P, _I, _L, _I, _I, _P],
    # a query, no launch: which body the attention forward runs at (dh, 2F)
    "commu_rel_attention_fwd_on_tensor_cores": [_I, _I],
}
# what an entry point returns where a shape needs more shared memory than a
# block may use (csrc/common.cuh::kRefusedSmem)
REFUSED_SMEM = -1
# workspace queries: bytes of scratch a kernel needs at a shape
_WORKSPACE = {
    "commu_rel_attention_mem_bwd_workspace": [_I] * 8,
    "commu_ffn_block_fwd_workspace": [_I] * 6,
    "commu_ffn_block_bwd_workspace": [_I] * 6,
    "commu_rel_attention_bwd_workspace": [_I] * 5,
    "commu_nll_fwd_workspace": [_I] * 4,
    "commu_nll_bwd_workspace": [_I] * 4,
    "commu_embed_grad_workspace": [_I] * 4,
    "commu_project_mem_kv_workspace": [_I] * 3,
    "commu_rel_attention_proj_fwd_workspace": [_I] * 5,
}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture, where a wrapper's launch only records a
    node: yields a dict that receives the launches the capture recorded, and
    takes them back off ``LAUNCHES`` on the way out.  Each replay of the
    graph launches them: ``add_launches`` counts them there."""
    before = dict(LAUNCHES)
    recorded = {}
    try:
        yield recorded
    finally:
        for name, count in before.items():
            if LAUNCHES[name] != count:
                recorded[name] = LAUNCHES[name] - count
                LAUNCHES[name] = count


def add_launches(recorded: dict) -> None:
    """Count the launches of one replay of a captured graph."""
    for name, count in recorded.items():
        LAUNCHES[name] += count


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcommu_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _compile(target: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:  # wait for every job before judging any
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent process sees all or nothing
    finally:
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _lib
    if _lib is None:
        path = _library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, argtypes in _WORKSPACE.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        lib.commu_error_string.argtypes = [ctypes.c_int]
        lib.commu_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def form(kernel: str, int8: bool = False, thresh: int = 0,
         bits: int = 16) -> str:
    """The name a launch is counted under: ``kernel``, ``kernel[int8]`` for
    an int8 product, or ``kernel[bits8]`` where only the masks (dropout on:
    ``thresh`` > 0) differ from the default form."""
    if int8:
        return f"{kernel}[int8]"
    return f"{kernel}[bits8]" if thresh > 0 and bits == 8 else kernel


def span(name: str):
    """A ``commu::<name>`` range in the trace while a ``torch.profiler`` runs
    (a no-op context otherwise, at the cost of one flag read): the launches
    made inside it are the range's, which is how a trace attributes each
    CUDA kernel to its wrapper, the clip or another phase."""
    import torch

    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(f"commu::{name}")
    return contextlib.nullcontext()


def launch(kernel: str, device, *args) -> None:
    """Call ``commu_<kernel>(*args, stream)`` on ``device``'s current CUDA
    stream and count the launch under ``kernel``; raises if the launch was
    refused (ValueError where the shape needs more shared memory than a
    block may use).  A ``[form]`` suffix only counts apart; a name in
    ``_ENTRY`` calls the entry point listed there.  Under a profiler the
    launch is a ``commu::<kernel>`` range (``span``)."""
    import torch

    lib = library()
    base = kernel.split("[")[0]
    entry = getattr(lib, f"commu_{_ENTRY.get(base, base)}")
    with torch.cuda.device(device), span(kernel):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*args, stream)
    if err == REFUSED_SMEM:
        raise ValueError(f"{kernel}: {lib.commu_error_string(err).decode()}")
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err}: "
                           f"{lib.commu_error_string(err).decode()}")
    LAUNCHES[kernel] += 1


def workspace(kernel: str, device, *shape):
    """A scratch tensor of the bytes ``commu_<kernel>_workspace(*shape)``
    asks for, on ``device`` (the kernel carves its buffers out of it)."""
    import torch

    nbytes = getattr(library(), f"commu_{kernel}_workspace")(*shape)
    return torch.empty((max(int(nbytes), 1),), dtype=torch.uint8, device=device)


def use_kernel(*tensors) -> bool:
    """Dispatch rule of every kernel wrapper: CPU tensors take the plain
    PyTorch version, CUDA tensors the kernel; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def check(name: str, tensor, shape, dtypes) -> None:
    """Raise unless ``tensor`` is contiguous with this shape and a dtype in
    ``dtypes`` (what a kernel launch assumes)."""
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(tensor.shape)}, expected "
                         f"{tuple(shape)}")
    if tensor.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {tensor.dtype} not in {dtypes}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
