"""The ceiling of the port's tensor-core step on this card.

K5, K6 and K7 run their 1x1 products as mma.sync m16n8k8 TF32 steps
(``ops/kernels/csrc/pointwise_mma.cuh``: ``pw::mma``).  This tool times
that instruction alone (``mma_ceiling.cu``), so that a kernel's MMA rate
can be held to what mma.sync reaches here as well as to the data sheet's
TF32 peak:

- the rate, TFLOP/s of dense TF32 work (2 * 16 * 8 * 8 FLOP an MMA), with
  every SM holding one block of 4, 8 or 16 warps (the pointwise kernels
  run one block of 16 an SM) and each warp issuing 1-16 independent MMAs
  a step, nothing else in the loop;
- the latency, SM clocks from one MMA to the next that depends on it.

Run on a machine with a CUDA card (the build takes seconds):

    python -m dsgcn_tpu_torch.tools.mma_ceiling

It prints one JSON row per measurement, the card's name and power limit,
and writes them all to ``chiprun_out/mma_ceiling.json`` at the repository
root.  It exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from dsgcn_tpu_torch.ops.kernels import _build

SOURCE = Path(__file__).resolve().with_suffix(".cu")
ROOT = Path(__file__).resolve().parents[2]
FLOP_PER_MMA = 2 * 16 * 8 * 8
WARPS, CHAINS = (4, 8, 16), (1, 2, 4, 8, 16)


def build() -> ctypes.CDLL:
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for src in sorted(_build.CSRC.glob("*.cuh")) + [SOURCE]:
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"libmma_ceiling-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}")
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(tmp), str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mma_ceiling_rate.argtypes = [P, I, I, I, I, P]
    lib.mma_ceiling_latency.argtypes = [P, P, I, P]
    return lib


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_ceiling: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    out = torch.empty(sms * 1024, device=dev)

    def check(code):
        if code != 0:
            raise RuntimeError(f"mma_ceiling launch failed ({code})")

    rows = []
    for warps in WARPS:
        for chains in CHAINS:
            iters = 65536 // chains

            def run():
                check(lib.mma_ceiling_rate(ctypes.c_void_p(out.data_ptr()),
                                           sms, 32 * warps, chains, iters,
                                           stream))
            run()
            times = []
            for _ in range(5):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                run()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            ms = min(times)
            flop = FLOP_PER_MMA * sms * warps * chains * iters
            row = dict(kind="rate", warps_per_sm=warps, chains=chains,
                       ms=ms, tflop_s=flop / ms / 1e9)
            rows.append(row)
            print(json.dumps(row), flush=True)
    clocks = torch.zeros(1, dtype=torch.int64, device=dev)
    for iters in (1024, 16384):
        check(lib.mma_ceiling_latency(ctypes.c_void_p(out.data_ptr()),
                                      ctypes.c_void_p(clocks.data_ptr()),
                                      iters, stream))
        torch.cuda.synchronize(dev)
        row = dict(kind="latency", iters=iters,
                   clocks_per_mma=clocks.item() / iters)
        rows.append(row)
        print(json.dumps(row), flush=True)
    name = card()
    print(name)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "mma_ceiling.json").write_text(json.dumps(
        dict(card=name, device=torch.cuda.get_device_name(dev), sms=sms,
             rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
