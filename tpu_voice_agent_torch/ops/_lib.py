"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels expose a plain C interface, so they are compiled by ``nvcc``
straight into one shared library and loaded with ``ctypes``: no PyTorch
headers, seconds per build instead of minutes. Each source compiles in its own
``nvcc`` process, all started together, and one link step joins the objects.
The library is keyed by a hash of the sources and flags and lands in
``cache_dir()`` (``_build/`` in the package unless ``TPU_VOICE_CACHE_DIR`` is
set), so a checkout builds once at first use and never at import. A build
that compiles is one compile-sentinel event (``utils.compilewatch``, site
``ops._lib.build``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .. import PACKAGE_DIR, cache_dir

CSRC = PACKAGE_DIR / "csrc"
# one nvcc process a source, all started together: the three parts of K2 /
# K3 / K12 (bf16 queries, fp32 queries, fp32 queries over an fp32 cache) and
# the two halves of K8 / K9 (the int8 and int4 pools)
# are sources of their own, the library's longest compiles otherwise
SOURCES = ("flash_attention.cu", "decode_attention.cu", "decode_block_attention.cu",
           "decode_block_attention_f32.cu", "decode_block_attention_f32kv.cu",
           "paged_attention.cu", "grammar_mask.cu",
           "paged_attention_quant.cu", "paged_attention_quant_int4.cu",
           "decode_attention_quant.cu", "grouped_matmul.cu")
HEADERS = ("common.cuh", "kv_chunk.cuh", "split_merge.cuh", "decode_split.cuh",
           "decode_attention.cuh", "paged_split.cuh", "paged_quant.cuh", "mma.cuh")
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
HEAD_DIMS = (16, 32, 48, 64, 128)
# the quantized-cache kernels (K8-K10) are built for the engines' head dims:
# test-tiny 32, the distilled checkpoint 48, tinyllama-1.1b 64, and 128 for
# the 8B-class models (llama3-8b, llama3-70b, mixtral-8x7b)
QUANT_HEAD_DIMS = (32, 48, 64, 128)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# per device: the int32 ticket counters of the kernels whose last block
# merges the others' partials (K2 / K3 / K5 to K10 / K12, K13's
# split-K), and the fp32 scratch the split-key attention kernels write those
# partials to
TICKETS: dict = {}
SCRATCH: dict = {}
# filled by build(): {"seconds": float, "cached": bool, "path": str, "log": str}
BUILD_INFO: dict = {}


def nvcc() -> str:
    path = os.environ.get("NVCC") or shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: set NVCC or put the CUDA toolkit on PATH")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/`` into the keyed shared library (no-op when it
    exists). ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel) and keeps the compiler output in ``BUILD_INFO["log"]``."""
    out_dir = cache_dir()
    lib = out_dir / f"libtva_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, cached=True, path=str(lib), log="")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir, prefix="build_"))
    extra = ("-Xptxas", "-v") if verbose else ()
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [nvcc(), *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        def finish(p):  # read each process's output as it runs; its wall when done
            text, _ = p.communicate()
            return text, time.perf_counter() - t0

        with ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, [p for _, _, p in procs]))
        logs, failed = [], []
        for (name, _obj, p), (text, wall) in zip(procs, done):
            logs.append(f"== {name} ({wall:.1f} s)\n{text}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n" + "\n".join(logs))
        so = tmp / "lib.so"
        link = subprocess.run(
            [nvcc(), "-shared", "-gencode", ARCH, "-o", str(so), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(so, lib)  # atomic: concurrent builds race safely
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False, path=str(lib),
                      log="\n".join(logs))
    # the largest stall the port can take mid-serving: one compile-sentinel
    # event with the build's wall
    from ..utils.compilewatch import get_compile_watcher

    get_compile_watcher().record("ops._lib.build", BUILD_INFO["seconds"] * 1e3,
                                 f"nvcc {len(SOURCES)} sources")
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        # q, k, v, o, lse (or null), B, T, S, nq, nkv, hd, kv_len, causal, scale, dtype,
        # o_f32, stream
        "tva_flash_attention": [P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, P],
        # q, k cache, v cache, kv_len, o, partials, tickets, B, S, nq, nkv, hd, chunk,
        # key_sets, scale, dtype, stream
        "tva_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P],
        # q, k plane, v plane, kv_len, o, partials, tickets, B, S, nq, nkv, hd, chunk, scale,
        # dtype, kv_dtype, stream
        "tva_decode_attention_layer": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, P],
        # q, k plane, v plane, q_positions, o, partials, tickets, B, T, S, nq, nkv, hd, chunk,
        # scale, dtype, kv_dtype, stream
        "tva_decode_block_attention_layer": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I,
                                             P],
        # q, flat k cache, flat v cache, q_positions, o, partials, tickets, B, T, S, nq, nkv,
        # hd, chunk, scale, dtype, kv_dtype, stream
        "tva_decode_block_attention": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, P],
        # q, k plane, v plane, table, kv_len, o, partials, tickets, B, max_blocks, bs, nq,
        # nkv, hd, chunk, scale, dtype, stream
        "tva_paged_attention": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, P],
        # q, k plane, v plane, table, q_positions, o, partials, tickets, B, T, max_blocks, bs,
        # nq, nkv, hd, chunk, scale, dtype, stream
        "tva_paged_block_attention": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P],
        # q, k plane, v plane, k scales, v scales, table, kv_len, o, partials, tickets, B,
        # max_blocks, bs, nq, nkv, hd, chunk, scale, bits, dtype, stream
        "tva_paged_attention_quant": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I,
                                      I, P],
        # q, k plane, v plane, k scales, v scales, table, q_positions, o, partials, tickets,
        # B, T, max_blocks, bs, nq, nkv, hd, chunk, scale, bits, dtype, stream
        "tva_paged_block_attention_quant": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                            F, I, I, P],
        # q, k cache, v cache, k scales, v scales, kv_len, o, partials, tickets, B, S, nq,
        # nkv, hd, chunk, key_sets, scale, bits, dtype, stream
        "tva_decode_attention_quant": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, I,
                                       P],
        # logits, state, mask, table, col_id, tok, next, B, V, C, rows a block, elements
        # a lane, stream
        "tva_masked_argmax_advance": [P, P, P, P, P, P, P, I, I, I, I, I, P],
        # logits, state, mask, tok, R, V, rows a block, elements a lane, stream
        "tva_masked_argmax": [P, P, P, P, I, I, I, I, P],
        # x, w (or int8 q), scales (int8 only, else 0), tile_expert, live_rows (or 0), out,
        # split-K partials, tickets (or 0), M, d, f, tm, chunk, x dtype, w dtype, stream
        "tva_grouped_matmul": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. A failed build raises;
    nothing falls back."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def tickets(device, n: int):
    """The device's int32 ticket counters, at least n, all 0 between
    launches (each launch sets back what it counted). Launches on one
    stream at a time share them."""
    import torch

    t = TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        TICKETS[device] = t
    return t


def scratch(device, n: int):
    """The device's fp32 scratch, at least n floats, grown on demand and
    reused by every launch: a launch writes and reads back its partials
    before it ends, so launches on one stream at a time share it."""
    import torch

    t = SCRATCH.get(device)
    if t is None or t.numel() < n:
        t = torch.empty(max(n, 1 << 16), dtype=torch.float32, device=device)
        SCRATCH[device] = t
    return t


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def require_cuda(name: str, *tensors) -> None:
    """Every operand on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        require(t.device.type == "cuda" and t.device == dev, name,
                f"operands must share one CUDA device (got {t.device})")
        require(t.is_contiguous(), name, "operands must be contiguous")


def dtype_code(name: str, t, what: str = "activations") -> int:
    """The attention kernels' type flag (``TVA_DTYPE_*`` in
    ``csrc/common.cuh``): 0 for bfloat16, 1 for float32; anything else
    raises."""
    import torch

    codes = {torch.bfloat16: 0, torch.float32: 1}
    require(t.dtype in codes, name, f"{what} must be bfloat16 or float32, got {t.dtype}")
    return codes[t.dtype]
