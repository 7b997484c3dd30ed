"""Build `csrc/*.cu` with nvcc on first use and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so a build takes
seconds: one ``nvcc -c`` per source, all started together, then one link.
It goes into ``rusty_sr_tpu_torch/_build/``, named by a hash of the
sources and flags, under a file lock so that concurrent processes build
it once; ``nvcc``'s own output (``-Xptxas -v``: registers, shared memory,
spills) is kept beside it in a ``.log`` file.  A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# No --use_fast_math: the kernels' sqrtf must stay IEEE and denormals must
# not flush.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsrtorch_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                       "CUDA_HOME to build the port's kernels")


def _run_all(cmds: list) -> list:
    """Run the commands at once; (cmd, returncode, output) for each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = []
    for cmd, p in procs:
        out, _ = p.communicate()
        results.append((cmd, p.returncode, out))
    return results


def build() -> str:
    """Compile the sources unless the library for them exists; returns its
    path."""
    so = library_path()
    if os.path.exists(so):
        return so
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so):
                _build_into(so)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


def _build_into(so: str) -> None:
    nvcc = _nvcc()
    tag = f"{so[:-3]}.{os.getpid()}"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(s)[:-3]}.o" for s in srcs]
    tmp = f"{tag}.so.tmp"
    try:
        runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                         for s, o in zip(srcs, objs)])
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        with open(so[:-3] + ".log", "w") as log:
            for cmd, _, out in runs:
                log.write(" ".join(cmd) + "\n" + out)
        failed = [(cmd, rc, out) for cmd, rc, out in runs if rc != 0]
        if failed:
            cmd, rc, out = failed[0]
            raise RuntimeError(f"nvcc failed with code {rc}: "
                               f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, so)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.unlink(path)


def build_log() -> str:
    """nvcc's output from the build of the current library ('' if none)."""
    path = library_path()[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.srt_trunk_f32.argtypes = [ptr] * 17 + [i32] * 5 + [ptr]
            lib.srt_trunk_f32.restype = i32
            lib.srt_trunk_bf16.argtypes = [ptr] * 13 + [i32] * 5 + [ptr]
            lib.srt_trunk_bf16.restype = i32
            lib.srt_depth_to_space.argtypes = [ptr] * 2 + [i32] * 6 + [ptr]
            lib.srt_depth_to_space.restype = i32
            lib.srt_epilogue.argtypes = ([ptr, ptr, i32, ptr] + [i32] * 12
                                         + [ptr])
            lib.srt_epilogue.restype = i32
            i64 = ctypes.c_longlong
            lib.srt_conv_stage.argtypes = (
                [ptr, i64, ptr, ptr, i64] + [i32] * 12
                + [ptr, ptr, ptr, i64, ptr, i64, ptr, i32, ptr])
            lib.srt_conv_stage.restype = i32
            lib.srt_window_attn.argtypes = ([ptr] * 3 + [i32] * 8
                                            + [ctypes.c_float, ptr])
            lib.srt_window_attn.restype = i32
            lib.srt_add_layernorm.argtypes = (
                [ptr] * 9 + [i64] * 2 + [i32] * 5 + [ctypes.c_float, ptr])
            lib.srt_add_layernorm.restype = i32
            lib.srt_hat_attn.argtypes = ([ptr] * 3 + [i32] * 9
                                         + [ctypes.c_float, ptr])
            lib.srt_hat_attn.restype = i32
            lib.srt_swin_mlp.argtypes = [ptr] * 5 + [i64] + [i32] * 3 + [ptr]
            lib.srt_swin_mlp.restype = i32
            lib.srt_error_string.argtypes = [i32]
            lib.srt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
