"""Build and load the hand-written Hopper kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/lib<name>.so`` at the repository root (a
directory ``.gitignore`` lists), then loaded with :mod:`ctypes`.  Builds
happen at first use, never at import: the CPU tests import every module.
:func:`build_all` starts one ``nvcc`` per source at once, so the whole
set costs about one compile.  A library newer than its source is reused.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`check` raises on anything but ``cudaSuccess``.  There is no
fallback: a source that does not build raises, and no caller switches to
the plain version.

Operands on the ``meta`` device (the launch dry-run's abstract step,
:mod:`repro_torch.launch.dryrun`) take a third route: the wrapper checks
them as for a launch, allocates its outputs (shapes and dtypes only) and
hands them to :func:`meta_call`, which records the call in
:data:`META_CALLS` in place of a launch.  No twin runs and no
``launches`` count moves.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only where the CUDA toolkit is installed")
    return nvcc


def sources() -> list[str]:
    """Names of every kernel source in ``csrc`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), CSRC / f"{name}.cu"
    deps = [src, *CSRC.glob("*.cuh")]
    return (not lib.exists()
            or lib.stat().st_mtime < max(d.stat().st_mtime for d in deps))


def _start(name: str) -> tuple[subprocess.Popen, str]:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))     # atomic: concurrent builds agree


def build_all(names: list[str] | None = None) -> list[str]:
    """Compile every stale kernel source in parallel; returns their names."""
    todo = [n for n in (names or sources()) if _stale(n)]
    procs = [(n, *_start(n)) for n in todo]
    errors = []
    for name, proc, tmp in procs:
        try:
            _finish(name, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, nargs_ptr: int, nargs_int: int,
         nargs_float: int = 0):
    """A C function taking ``nargs_ptr`` pointers, then ``nargs_int``
    64-bit ints, then ``nargs_float`` floats, then the stream; returning
    a CUDA error code."""
    fn = getattr(load(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * nargs_ptr
                   + [ctypes.c_longlong] * nargs_int
                   + [ctypes.c_float] * nargs_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain twin), False when all lie on one CUDA device (it launches its
    kernel) or all on ``meta`` (it records a :func:`meta_call`); raises
    on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands lie on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type in ("cuda", "meta"):
        return False
    raise ValueError(f"no kernel for tensors on {dev}")


#: kernel name -> {"calls", "launches", "operand_bytes", "output_bytes"}
#: of the calls made on ``meta`` operands (clear it with ``.clear()``)
META_CALLS: dict[str, dict] = {}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def meta_call(name: str, operands, outputs, launches: int = 1) -> bool:
    """Record one call of kernel ``name`` when its operands lie on
    ``meta``, with the bytes of ``operands`` and of ``outputs`` (a tensor
    or a tuple, allocated by the wrapper as for a launch), and return
    True: the wrapper then returns its outputs.  False on a real device,
    where the wrapper goes on to launch.  ``launches`` is what the call
    adds to the wrapper's count on the card."""
    if operands[0].device.type != "meta":
        return False
    rec = META_CALLS.setdefault(name, dict.fromkeys(
        ("calls", "launches", "operand_bytes", "output_bytes"), 0))
    rec["calls"] += 1
    rec["launches"] += launches
    rec["operand_bytes"] += _nbytes(operands)
    flat = outputs if isinstance(outputs, tuple) else (outputs,)
    rec["output_bytes"] += _nbytes(flat)
    return True


def check(err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        import torch
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
