"""Compile the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>-<hash>.so`` through one ``nvcc``
call for ``sm_90a``.  The sources expose a plain C interface and include no
PyTorch headers, so a build takes seconds; ``build_all`` starts one ``nvcc``
per source at once.  Libraries live in ``build/kernels`` at the repository
root (listed in ``.gitignore``), named by a hash of their sources and flags,
so an edited source is never served from a stale build.  Nothing here runs
at import time; :func:`custom_op` registers a kernel's op when its wrapper's
module is imported, and builds nothing.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# The block of K1 and K3 (csrc/graph_agg_tiled.cuh), defined here once for
# the kernels (as -D flags) and for the planner (dyn_graph.agg_plan): most
# threads a block, rows of pre a ring stage, ring stages, and the
# destination joints a thread holds (WN) at each compile-time joint bound
AGG_MAX_THREADS, AGG_ROWS, AGG_STAGES = 256, 8, 3
AGG_JOINTS_PER_THREAD = {25: 4, 32: 3}
# The contraction block of K2 (csrc/dyn_graph_bwd.cu), likewise for the
# kernel and its planner (dyn_graph.bwd_plan): most threads a block, rows
# of pre and dy a ring stage, ring stages, and the source joints a thread
# holds (two rows of VB floats each: G's and dG's), and the blocks an SM
# must hold at once, which caps a thread's registers (ptxas allows 128 for
# two 224-thread blocks).
BWD_MAX_THREADS, BWD_ROWS, BWD_STAGES, BWD_MIN_BLOCKS = 224, 4, 3, 2
BWD_JOINTS_PER_THREAD = {25: 2, 32: 1}
# K2's edge product dx = edge_w dP splits its depth over this many blocks a
# sample, whose parts the finish kernel adds
BWD_DX_PARTS = 4
# The block of K5 and K6 (csrc/pointwise_mma.cuh), likewise for the kernels
# and their planners (dyn_graph.eval_plan, dggcn_block.block_plan): threads
# a block (16 warps; each holds 32 rows of a 1x1 product's tile), the least
# depth of a weight panel, the panels in the cp.async ring and the least
# width a ring slot holds (a narrower product's panels take more rows);
# then each kernel's caps on the n8 accumulator tiles a warp holds (K6: the
# out accumulator, 64 registers at 8, and a pre chunk's; K5: a pre
# chunk's), the destination joints an aggregation thread takes and (K6)
# the source joints of one pass, whose graph entries it holds in registers
PW_THREADS, PW_KP, PW_STAGES, PW_WARP_ROWS = 512, 16, 2, 32
PW_PANEL_WIDTH = 256
K6_OUT_TILES, K6_PRE_TILES = 8, 4
K6_JOINTS_PER_THREAD, K6_SOURCE_JOINTS = 2, 13
K5_PRE_TILES, K5_JOINTS_PER_THREAD = 8, 2
# K7 (csrc/ms_tcn.cu) runs on the same block, x panels of PW_KP channels
# beside the weight panels in its ring; a warp holds up to K7_TILES n8
# accumulator tiles of a product in one pass
K7_TILES = 8
# The card the planners plan for (an H100): SMs, shared memory an SM and
# the most a block may take.  The pointwise planners' cost model (K5, K6
# and K7), in SM clocks: the TF32 rate mma.sync reaches, in FLOP a clock an
# SM (half the H100's dense TF32 rate), one thread's instructions to build
# a graph entry (the exponential-table ctr, the base, the gate, the
# rounding), a weight panel's barrier, the bytes an SM moves a clock at the
# card's memory rate (3.35 TB/s over 132 SMs at 1.98 GHz), and a K6
# chunk's, a K5 block's or a K7 product's fixed clocks (barriers, tables,
# epilogue).  The model only ranks plans; ``chip_smoke.py --sweep-blocks``
# times every plan that fits at the main paths' shapes beside the chosen
# one.
SMS, SM_SMEM, BLOCK_SMEM = 132, 228 * 1024, 227 * 1024
MMA_FLOP_CLK, ENTRY_INSTR, PANEL_CLK, BYTES_CLK = 1024, 12, 60, 13
CHUNK_CLK = 2000
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DDSGCN_AGG_MAX_THREADS={AGG_MAX_THREADS}",
              f"-DDSGCN_AGG_ROWS={AGG_ROWS}",
              f"-DDSGCN_AGG_STAGES={AGG_STAGES}") + tuple(
    f"-DDSGCN_AGG_WN{vb}={wn}" for vb, wn in AGG_JOINTS_PER_THREAD.items()) + (
    f"-DDSGCN_BWD_MAX_THREADS={BWD_MAX_THREADS}",
    f"-DDSGCN_BWD_ROWS={BWD_ROWS}",
    f"-DDSGCN_BWD_STAGES={BWD_STAGES}",
    f"-DDSGCN_BWD_MIN_BLOCKS={BWD_MIN_BLOCKS}",
    f"-DDSGCN_BWD_DX_PARTS={BWD_DX_PARTS}") + tuple(
    f"-DDSGCN_BWD_WN{vb}={wn}" for vb, wn in BWD_JOINTS_PER_THREAD.items()) + (
    f"-DDSGCN_PW_THREADS={PW_THREADS}", f"-DDSGCN_PW_KP={PW_KP}",
    f"-DDSGCN_PW_STAGES={PW_STAGES}",
    f"-DDSGCN_PW_PANEL_WIDTH={PW_PANEL_WIDTH}",
    f"-DDSGCN_PW_WARP_ROWS={PW_WARP_ROWS}",
    f"-DDSGCN_K6_OUT_NT={K6_OUT_TILES}",
    f"-DDSGCN_K6_PRE_NT={K6_PRE_TILES}",
    f"-DDSGCN_K6_WN={K6_JOINTS_PER_THREAD}",
    f"-DDSGCN_K6_VC={K6_SOURCE_JOINTS}",
    f"-DDSGCN_K5_PRE_NT={K5_PRE_TILES}",
    f"-DDSGCN_K5_WN={K5_JOINTS_PER_THREAD}",
    f"-DDSGCN_K7_NT={K7_TILES}")

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (C entry point, argtypes); see the extern "C" functions in csrc
SIGNATURES = {
    "bd_agg": ("dsgcn_bd_agg", [_P, _P, _I] + [_P] * 10 + [_I] * 10 + [_P]),
    "dyn_graph": ("dsgcn_dyn_graph_fwd",
                  [_P, _P, _I] + [_P] * 11 + [_I] * 10 + [_P]),
    "dyn_graph_bwd": ("dsgcn_dyn_graph_bwd",
                      [_P, _P, _P, _I] + [_P] * 22 + [_I] * 11 + [_P]),
    "dyn_graph_eval": ("dsgcn_dyn_graph_eval",
                       [_P] * 4 + [_I] + [_P] * 5 + [_I] * 10 + [_P] * 5),
    "dggcn_block": ("dsgcn_dggcn_block",
                    [_P, _P, _I] + [_P] * 21 + [_I] * 12 + [_P]),
    "ms_tcn": ("dsgcn_ms_tcn", [_P, _P, _I, _P] + [_P] * 5 + [_I] * 15
               + [_P]),
}

_lock = threading.Lock()
_entry_points: Dict[str, object] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_kernel(name: str) -> Path:
    """Build ``csrc/<name>.cu`` unless a build of the same sources exists.
    ptxas's register/spill report goes to the ``.log`` beside the library.
    Processes sharing the build directory (the ranks of one launch) build a
    source once: the first takes the source's file lock, the others wait
    for it and load its library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def build_all() -> Dict[str, float]:
    """Build every kernel, one nvcc per source started together; returns the
    seconds each build took (0 where a current build existed)."""
    def timed(name):
        t0 = time.perf_counter()
        compile_kernel(name)
        return time.perf_counter() - t0
    with ThreadPoolExecutor(len(SIGNATURES)) as ex:
        futures = {name: ex.submit(timed, name) for name in SIGNATURES}
        return {name: f.result() for name, f in futures.items()}


def entry_point(name: str):
    """The kernel's C launcher (built and loaded on first use)."""
    with _lock:
        fn = _entry_points.get(name)
        if fn is None:
            symbol, argtypes = SIGNATURES[name]
            lib = ctypes.CDLL(str(compile_kernel(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, symbol + "_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            fn.error_string = err
            _entry_points[name] = fn
        return fn


def launch(name: str, *args) -> None:
    """Call the kernel's launcher; raise if the launch was refused."""
    fn = entry_point(name)
    code = fn(*args)
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{fn.error_string(code).decode()} ({code})")


def ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def graph_operand(t: torch.Tensor, shape, name: str,
                  device: torch.device) -> torch.Tensor:
    """A small graph operand as the contiguous float32 tensor the kernels
    read (the Pallas wrappers cast these to float32 too); raises on a wrong
    shape, device or type."""
    if t is None:
        raise ValueError(f"{name} is required")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, pre is on {device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return t.float().contiguous()


def check_activation(pre: torch.Tensor, name: str) -> None:
    """The large input of a kernel: on a CUDA device, float32 or bfloat16,
    contiguous; raises on what the kernel cannot take."""
    if pre.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {pre.device}")
    if pre.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: pre must be float32 or bfloat16, "
                        f"got {pre.dtype}")
    if not pre.is_contiguous():
        raise ValueError(f"{name}: pre must be contiguous")


# what the kernels take (csrc/graph_agg.cuh VMAX, EMAX; the grid's z axis;
# csrc/dyn_graph_bwd.cu GEMM_MAX_M: K2's edge products take the edge
# subset's Cm channels and the bias row in one block's rows)
MAX_JOINTS, MAX_EDGE_CLASSES, MAX_SAMPLES = 32, 16, 65535
MAX_BWD_EDGE_CHANNELS = 127


def check_limits(name: str, N: int, V: int, E: int) -> None:
    """Refuse sizes the kernels do not take."""
    if not 1 <= V <= MAX_JOINTS:
        raise ValueError(f"{name}: {V} joints; the kernel takes 1-{MAX_JOINTS}")
    if E > MAX_EDGE_CLASSES:
        raise ValueError(f"{name}: {E} edge classes; the kernel takes at "
                         f"most {MAX_EDGE_CLASSES}")
    if N > MAX_SAMPLES:
        raise ValueError(f"{name}: batch {N} over {MAX_SAMPLES}; split it")


# The namespace of the kernels' custom ops: ``dsgcn`` for this package; a
# second copy of the kernels loaded under another package name (e.g. a
# parent commit's, timed beside these) registers its own
OP_NAMESPACE = ("dsgcn" if __name__.startswith("dsgcn_tpu_torch.")
                else "dsgcn_" + __name__.split(".")[0])


def custom_op(name: str, schema: str, plain, kernel, fake):
    """Register the kernel as the custom op ``dsgcn::<name>`` of ``schema``:
    ``plain`` (its plain version) on CPU tensors, ``kernel`` (the launcher,
    which checks the call, plans on the batch and counts the launch) on
    CUDA tensors, ``fake`` (output shapes and dtypes only) under tracing,
    so that ``torch.export`` keeps the op as one node.  Registering builds
    nothing; returns the op, called like a function."""
    op = torch.library.custom_op(f"{OP_NAMESPACE}::{name}", plain,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(kernel)
    op.register_fake(fake)
    return op


def refuse_grad(name: str, *tensors) -> None:
    """K3-K7 are eval-only (their TPU kernels have no backward): refuse
    inputs that need a gradient.  Training aggregates through K1 and K2,
    and takes the module path of the temporal convs."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is eval-only and has no backward; call it under "
            "torch.no_grad() or torch.inference_mode(), or train through "
            "fused_dyn_graph_agg (K1 and its backward K2) and the temporal "
            "convs' module path")
