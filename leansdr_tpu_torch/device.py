"""Device selection and the build of the hand-written CUDA kernels.

Entry points default to ``cuda``. ``device="cpu"`` must be asked for
explicitly (the CPU tests do), and then every kernel wrapper runs its
plain PyTorch version. Asking for ``cuda`` without a GPU raises: nothing
carries on quietly on the CPU.

Kernels live in ``csrc/*.cu`` with a plain C entry point each. A source
is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [per-kernel flags] -o lib<name>_<hash>.so

into ``_build/`` (gitignored), keyed by a hash of the source and the
flags (the pattern of the byte backend's g++ build), and loaded with
ctypes. A failed build or launch raises; nothing falls back to the plain
version.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD = _DIR / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

# Per-kernel nvcc flags. The demod recurrences and the FIR must round like
# their plain PyTorch versions (one rounding per operation; the demods'
# IEEE cosf/sinf/sqrtf/logf and division), so multiply-add contraction is
# off for them and fast math is never used. The --hs demod is integer
# arithmetic but for mu, which it also keeps uncontracted.
KERNEL_FLAGS = {
    "demod": ["--fmad=false"],
    "acs": [],
    "acs_banked": [],
    "fir": ["--fmad=false"],
    "fft4096": [],
    "scan_demod": ["--fmad=false"],
    "hs_demod": ["--fmad=false"],
}


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. CUDA without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def fp32_matmul():
    """Float32 matrix products in full float32 (TF32 off) inside the
    block, the previous setting restored after it."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _target(name: str) -> tuple[list, Path]:
    src = CSRC / f"{name}.cu"
    flags = ARCH + BASE_FLAGS + KERNEL_FLAGS[name]
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                         ).hexdigest()[:16]
    return flags, BUILD / f"lib{name}_{tag}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet,
    one nvcc process per source, all started together and all waited
    for. Returns {name: (so_path, ptxas_report)}. Raises if any failed."""
    names = list(KERNEL_FLAGS) if names is None else list(names)
    BUILD.mkdir(exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        flags, so = _target(name)
        log = so.with_suffix(".log")
        if so.exists():
            out[name] = (so, log.read_text() if log.exists() else "")
            continue
        tmp = f"{so}.{os.getpid()}.tmp"      # unique: concurrent builders
        cmd = [nvcc_path()] + flags + [str(CSRC / f"{name}.cu"), "-o", tmp]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, so, log, cmd)
    failed = []
    for name, (p, tmp, so, log, cmd) in procs.items():
        try:
            text, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu ({' '.join(cmd)}):"
                          f"\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, so)                  # atomic publish
        out[name] = (so, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_libs = {}
_lock = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so, _ = build([name])[name]
            lib = ctypes.CDLL(str(so))
            _libs[name] = lib
        return lib


def stream_handle(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device):
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device` (the kernel wrappers' argument check)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
