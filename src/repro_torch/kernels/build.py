"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``_build/lib<name>-<digest>.so`` beside this file (a git-ignored
directory), where the digest covers the source, every local header in
``csrc/`` (``*.cuh``, ``*.h``) and the flags: an edited source or header
builds anew, an unchanged one is reused.  Nothing is compiled when
this module is imported; :func:`load` builds at first use, and
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).parent / "csrc"
# every kernel of the port, one csrc/<name>.cu each
KERNELS = ("fused_w4a4_lrc", "fused_prologue", "w4a4_lowrank_matmul",
           "act_quant", "paged_flash_attention", "paged_flash_attention_quant",
           "flash_attention", "flash_attention_quant", "fwht")
BUILD_DIR = Path(__file__).parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# what the last build of each kernel printed (ptxas registers / spills)
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and $PATH)")
    return found


def headers() -> list:
    """The local headers a source may include, in a fixed order."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cuh", ".h"))


def target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *headers()]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, all ``nvcc`` runs
    in parallel.  Returns the wall seconds of the build per name (0.0 when
    reused).  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    seconds = {}
    t0 = time.perf_counter()
    for name in names:
        out = target(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def check_activations(x, bits: int) -> None:
    """What every kernel's wrapper asks of its activations x."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not 2 <= bits <= 8:
        raise ValueError(f"activation bits must be in [2, 8], got {bits}")


def check_operands(first, tensors) -> None:
    """Every operand of a launch on ``first``'s device, which is the current
    CUDA device, and contiguous."""
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"all operands must be on {first.device}; one is on {t.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if first.device.index != torch.cuda.current_device():
        raise ValueError(f"operands are on {first.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def refuse_grad(name: str, *tensors) -> None:
    """No kernel has a backward.  Under grad mode an input that requires
    grad would give an output autograd cannot differentiate (no
    ``grad_fn``), and a training step through it would leave the inputs'
    gradients silently at zero: raise instead.  Train through the plain
    routes (``KernelContext(attention="gather")``, float weights)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: called under grad mode with an input that "
            f"requires grad; run it under torch.no_grad() or detach the inputs")


def stream_of(t) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(target(name)))
        _LIBS[name] = lib
    return lib
