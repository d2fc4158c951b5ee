"""GPU smoke run of the PyTorch/CUDA port (``dsgcn_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dsgcn_tpu_torch/ops/kernels/csrc``,
holds each against its plain PyTorch version on the card at the DS-GCN
block shapes, serves full-width DS-GCN through ``init_recognizer`` /
``inference_recognizer`` (random seeded weights, gates nudged off zero,
BN statistics taken from data), checks the kernels were launched on that
path and that the GPU answers match the same model on the CPU, and times a
batch forward.  Any
failed check raises, and the script exits non-zero without a result line.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it lists the kernels with their launches, errors and
times.  Per-shape kernel numbers also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "dsgcn" / "ntu60_xsub_3dkp" / "j.py"
# DS-GCN at b64 x M2 x T100: (mid, T at the GCN, blocks with this shape)
BLOCK_SHAPES = [(8, 100, 4), (16, 100, 1), (16, 50, 2), (32, 50, 1),
                (32, 25, 2)]
N_BLOCK = 128
V, K, E = 25, 3, 15
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # CUDA-core float32, H100 SXM data sheet
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SPIN_CYCLES = 5_000_000        # ~2.5 ms of device time at 1.98 GHz


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cold_ms(fn, iters: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each after the L2
    cache was overwritten (the caller's producer has moved on).  A spin
    kernel ahead of the start event keeps the device busy while the host
    enqueues ``fn``, so the events bracket device work only, not the
    wrapper's Python."""
    fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at the block shapes
# ---------------------------------------------------------------------------

def block_inputs(rng, dev, Cm, T, dtype, Vp=V, v_real=-1):
    """K1 and K3 inputs of one DS-GCN block's aggregation (random, with the
    NTU edge classes)."""
    from dsgcn_tpu_torch.graph import Graph
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import edge_onehot
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    N = N_BLOCK
    d = dict(pre=f(N, T, Vp, K * Cm).to(dtype), x1=f(N, K, Cm, Vp),
             x2=f(N, K, Cm, Vp), A=f(K, Vp, Vp) * 0.04,
             alpha=f(K).clamp(-1, 1), beta=f(K).clamp(-1, 1),
             ew=f(Cm, E * Cm) * 0.2, eb=f(E * Cm) * 0.1)
    sel = edge_onehot(Graph(layout="nturgb+d", mode="spatial").edge_type, E)
    sel = np.pad(sel, ((0, 0), (0, Vp - V), (0, Vp - V)))
    d["sel"] = torch.from_numpy(sel).to(dev)
    if v_real > 0:   # padded joints: zero values, as the model pads them
        d["pre"][:, :, v_real:] = 0
    q1, q2 = d["x1"][:, 1], d["x2"][:, 1]
    w = d["ew"]
    p1 = torch.einsum("ncv,cf->nfv", q1, w).reshape(N, E, Cm, Vp)
    p2 = torch.einsum("ncv,cf->nfv", q2, w).reshape(N, E, Cm, Vp)
    d.update(pre2=d["pre"].reshape(N, T, Vp * K * Cm),
             x1t=d["x1"].transpose(-1, -2).contiguous(),
             p1t=p1.transpose(-1, -2).contiguous(), p2=p2.contiguous(),
             ebias=torch.einsum("evw,ec->vcw", d["sel"],
                                d["eb"].reshape(E, Cm)).contiguous())
    return d


def kernel_calls(d, Cm, edge, v_real=-1):
    """(kernel, plain, library) callables per kernel name."""
    from dsgcn_tpu_torch.ops.kernels.bd_agg import (
        bd_dyn_graph_agg, reference_bd_dyn_graph_agg)
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
        fused_dyn_graph_agg, reference_dyn_graph_agg)
    ek = 1 if edge else -1
    k1 = (d["pre"], d["x1"], d["x2"], d["A"], d["alpha"], d["beta"]) + (
        (d["ew"], d["eb"], d["sel"]) if edge else (None, None, None)) + (
        K, Cm, ek, E, v_real)
    k3 = (d["pre2"], d["x1t"], d["x2"], d["A"], d["alpha"], d["beta"]) + (
        (d["p1t"], d["p2"], d["sel"], d["ebias"]) if edge
        else (None, None, None, None))
    k3kw = dict(K=K, Cm=Cm, edge_k=ek, edge_num=E, v_real=v_real)
    # the library yardstick: the aggregation alone, one einsum over a
    # prebuilt graph (it does not build the graph)
    N, T, Vp, _ = d["pre"].shape
    G = torch.randn(N, K, Cm, Vp, Vp, device=d["pre"].device).to(
        d["pre"].dtype)
    pre5 = d["pre"].reshape(N, T, Vp, K, Cm)
    library = lambda: torch.einsum("ntvkc,nkcvw->ntwkc", pre5, G)  # noqa
    return {
        "fused_dyn_graph_agg": (lambda: fused_dyn_graph_agg(*k1),
                                lambda: reference_dyn_graph_agg(*k1),
                                library),
        "bd_dyn_graph_agg": (lambda: bd_dyn_graph_agg(*k3, **k3kw),
                             lambda: reference_bd_dyn_graph_agg(*k3, **k3kw),
                             library),
    }


def bound(d, name, Cm, edge):
    """Least time for the call's work on the card (ms) and what bounds it:
    each input read once and the output written once over the memory rate,
    against the aggregation's and the graph build's float32 operations
    over the CUDA-core rate (the kernels compute in float32)."""
    N, T, Vp, KC = d["pre"].shape
    keys = (["pre", "x1", "x2", "A", "alpha", "beta"]
            + (["ew", "eb", "sel"] if edge else [])
            if name == "fused_dyn_graph_agg" else
            ["pre2", "x1t", "x2", "A", "alpha", "beta"]
            + (["p1t", "p2", "sel", "ebias"] if edge else []))
    nbytes = sum(d[k].numel() * d[k].element_size() for k in keys)
    nbytes += d["pre"].numel() * d["pre"].element_size()       # y
    flops = 2 * N * T * Vp * Vp * KC                            # y
    flops += N * K * (2 * Cm * Vp * Vp + 4 * Cm * Vp * Vp)      # ada + G
    if edge:
        flops += N * Cm * Vp * Vp * 2 * E                       # edge ctr
        if name == "fused_dyn_graph_agg":
            flops += N * 2 * (2 * Cm * E * Cm * Vp)             # P1, P2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_checks(dev, rng, report):
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    worst = {}
    per_forward = {}
    cases = []
    for Cm, T, nblocks in BLOCK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for edge in (True, False):
                cases.append((Cm, T, nblocks, dtype, edge, V, -1))
            cases.append((Cm, T, nblocks, dtype, True, 32, 25))
    for Cm, T, nblocks, dtype, edge, Vp, v_real in cases:
        d = block_inputs(rng, dev, Cm, T, dtype, Vp, v_real)
        for name, (kern, plain, library) in kernel_calls(
                d, Cm, edge, v_real).items():
            if v_real > 0 and name == "fused_dyn_graph_agg":
                continue     # v_real on V=32 is checked for K3
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                atol=tol)
            row = dict(kernel=name, Cm=Cm, T=T, N=N_BLOCK, V=Vp,
                       v_real=v_real, dtype=str(dtype).split(".")[-1],
                       edge=edge, max_abs_err=err, max_abs_ref=scale,
                       tol=tol, ok=ok)
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} non-finite output at {row}")
            check(ok, f"{name} disagrees with its plain version: {row}")
            worst[name] = max(worst.get(name, 0.0), err)
            if Vp == V and edge:
                # the DS-GCN path's own configuration: time it
                ms = cold_ms(kern, flush=flush)
                plain_ms = cold_ms(plain, iters=3, flush=flush)
                library_ms = cold_ms(library, flush=flush)
                bound_ms, bound_by = bound(d, name, Cm, edge)
                row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           blocks_per_forward=nblocks)
                if dtype == torch.float32:
                    acc = per_forward.setdefault(name, dict(
                        ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        bound_by=set()))
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        acc[k] += nblocks * row[k]
                    acc["bound_by"].add(bound_by)
            report["kernel_checks"].append(row)
            print("kernel", json.dumps(row), flush=True)
        del d
    return worst, per_forward


# ---------------------------------------------------------------------------
# phase 3-5: serving through the entry points
# ---------------------------------------------------------------------------

def calibrate_(model, kp, seed):
    """Realistic eval weights from random ones.  The gates, joint
    coefficients and graphs are moved off their initial values (zero gates
    would hide the ctr/ada graphs); then every BatchNorm takes the
    statistics of its input on ``kp``, so activations keep unit scale
    through the ten blocks and the logits depend on the input; then the BN
    affines are moved off (1, 0)."""
    from dsgcn_tpu_torch.ops.common import BatchNorm

    g = torch.Generator().manual_seed(seed)

    def noise(t, lo, hi):
        return torch.empty(t.shape).uniform_(lo, hi, generator=g).to(t)

    def take_stats(bn, args):
        x = args[0].float().reshape(-1, bn.num_features)
        bn.running_mean.copy_(x.mean(0))
        var = x.var(0, unbiased=False)
        # floor: channels near constant on the calibration clip (the
        # zero-padded second body) must not amplify other inputs
        bn.running_var.copy_(var + 0.5 * var.mean() + 1e-3)

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for name, t in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("alpha", "beta"):
                t.copy_(noise(t, -1, 1))
            elif leaf == "add_coeff":
                t.copy_(noise(t, -0.5, 0.5))
            elif leaf == "A":
                t.add_(noise(t, -0.05, 0.05))
        hooks = [m.register_forward_pre_hook(take_stats) for m in bns]
        try:
            model(kp)
        finally:
            for h in hooks:
                h.remove()
        # the BN that closes a residual branch (gcn.bn, tcn.bn) gets a small
        # scale, as the reference's block init keeps blocks near identity:
        # unit-scale branches would double the variance at every residual
        # add and amplify rounding noise through the ten blocks
        closing = {id(m) for name, m in model.named_modules()
                   if name.endswith(("gcn.bn", "tcn.bn"))}
        for m in bns:
            lo, hi = (0.2, 0.4) if id(m) in closing else (0.8, 1.2)
            m.weight.copy_(noise(m.weight, lo, hi))
            m.bias.copy_(noise(m.bias, -0.1, 0.1))


def synthetic_annos(seed, n=4):
    """NTU-shaped skeleton annotations (2 bodies, 25 joints, xyz, metres):
    a random pose per body moving along a smooth per-request trajectory,
    with per-request scale and jitter, so requests differ in what the
    model pools."""
    rng = np.random.default_rng(seed)
    annos = []
    for i, t in enumerate((103, 80, 150, 64)[:n]):
        pose = rng.standard_normal((2, 1, 25, 3)) * 0.3 * (1 + i)
        phase = np.linspace(0, (2 + i) * np.pi, t)[None, :, None, None]
        motion = np.sin(phase + rng.uniform(0, np.pi, (2, 1, 25, 3)))
        kp = pose + 0.2 * motion + 0.02 * rng.standard_normal((2, t, 25, 3))
        kp = kp.astype(np.float32)
        kp[1, t // 2:] = 0          # the second body leaves the scene
        annos.append(dict(frame_dir=f"S{i:03d}", label=int(i),
                          keypoint=kp, total_frames=t))
    return annos


def reset_counts():
    from dsgcn_tpu_torch.ops.kernels.bd_agg import bd_dyn_graph_agg
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import fused_dyn_graph_agg
    bd_dyn_graph_agg.launches = fused_dyn_graph_agg.launches = 0


def read_counts():
    from dsgcn_tpu_torch.ops.kernels.bd_agg import bd_dyn_graph_agg
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import fused_dyn_graph_agg
    return {"bd_dyn_graph_agg": bd_dyn_graph_agg.launches,
            "fused_dyn_graph_agg": fused_dyn_graph_agg.launches}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float().cpu() - b.float().cpu()).abs().max()
            / b.float().abs().max()).item()


def logits_of(model, pipeline, anno):
    kp = torch.from_numpy(pipeline(dict(anno))["keypoint"])
    dev = next(model.parameters()).device
    with torch.inference_mode():
        return model(kp.to(dev)).cpu()


def serve(dev, report):
    from dsgcn_tpu_torch.apis import (inference_recognizer, init_recognizer,
                                      to_bf16_inference)
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.data.transforms import build_pipeline

    torch.manual_seed(0)
    model = init_recognizer(str(CONFIG), device=dev)
    pipeline = build_pipeline(model.cfg["data"]["test"]["pipeline"])
    calib = synthetic_annos(seed=1)[0]
    calibrate_(model, torch.from_numpy(
        pipeline(calib)["keypoint"]).to(dev), seed=1)
    annos = synthetic_annos(seed=2)
    nblocks = model.backbone.num_blocks
    check(nblocks == 10, f"DS-GCN has {nblocks} blocks, expected 10")

    # phase 3: the main path, counts read around it; each request's wall
    # time (pipeline + forward + scores back on the host)
    reset_counts()
    answers, request_ms = [], []
    for a in annos:
        t0 = time.perf_counter()
        answers.append(inference_recognizer(model, a))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    main_counts = read_counts()
    print("main path launches", json.dumps(main_counts), flush=True)
    print("request latency ms (f32, 10 clips x 2 bodies x 60 frames): "
          + ", ".join(f"{ms:.3f}" for ms in request_ms), flush=True)
    report["request_ms"] = {"f32": request_ms}
    check(main_counts["bd_dyn_graph_agg"] == nblocks * len(annos),
          f"bd_dyn_graph_agg launched {main_counts['bd_dyn_graph_agg']} "
          f"times for {len(annos)} forwards of {nblocks} blocks")
    check(main_counts["fused_dyn_graph_agg"] == 0,
          "the default path launched fused_dyn_graph_agg")

    cpu = init_recognizer(str(CONFIG), device="cpu")
    cpu.load_state_dict(model.state_dict(), strict=True)
    for a, ans in zip(annos, answers):
        cpu_ans = inference_recognizer(cpu, a)
        g, c = logits_of(model, pipeline, a), logits_of(cpu, pipeline, a)
        check(g.shape == (10, 60) and bool(torch.isfinite(g).all()),
              f"logits of shape {tuple(g.shape)} or not finite")
        err = rel_err(g, c)
        print(f"request {a['frame_dir']}: gpu top-5 {ans}", flush=True)
        print(f"request {a['frame_dir']}: cpu top-5 {cpu_ans}", flush=True)
        print(f"request {a['frame_dir']}: logits rel err {err:.3e} "
              f"(max |logit| {c.abs().max().item():.3f})", flush=True)
        check(ans[0][0] == cpu_ans[0][0],
              f"GPU top-1 {ans[0]} != CPU top-1 {cpu_ans[0]}")
        check(err <= 1e-3, f"GPU logits off the CPU's by {err:.3e} rel")
        report["serving"].append(dict(request=a["frame_dir"], top5=ans,
                                      cpu_top5=cpu_ans, logits_rel_err=err))

    # phase 4: the options on the same weights
    cfg = Config.fromfile(str(CONFIG))
    cfg["model"]["backbone"]["gcn_eval_kernel"] = "fused"
    fused = init_recognizer(cfg, device=dev)
    fused.load_state_dict(model.state_dict(), strict=True)
    reset_counts()
    fused_answers = [inference_recognizer(fused, a) for a in annos]
    torch.cuda.synchronize()
    fused_counts = read_counts()
    print("fused path launches", json.dumps(fused_counts), flush=True)
    check(fused_counts["fused_dyn_graph_agg"] == nblocks * len(annos),
          f"fused_dyn_graph_agg launched "
          f"{fused_counts['fused_dyn_graph_agg']} times")
    check(fused_counts["bd_dyn_graph_agg"] == 0,
          "the fused option launched bd_dyn_graph_agg")
    for a, ans, fans in zip(annos, answers, fused_answers):
        err = rel_err(logits_of(fused, pipeline, a),
                      logits_of(model, pipeline, a))
        print(f"request {a['frame_dir']}: fused vs bd logits rel err "
              f"{err:.3e}", flush=True)
        check(err <= 1e-4, f"fused logits off bd by {err:.3e} rel")
        check(fans[0][0] == ans[0][0], "fused top-1 differs from bd")

    bf16 = to_bf16_inference(model)
    report["request_ms"]["bf16"] = []
    for a, ans in zip(annos, answers):
        t0 = time.perf_counter()
        bans = inference_recognizer(bf16, a)
        report["request_ms"]["bf16"].append(
            (time.perf_counter() - t0) * 1e3)
        print(f"request {a['frame_dir']}: bf16 top-5 {bans}", flush=True)
        check(bans[0][0] == ans[0][0],
              f"bf16 top-1 {bans[0]} != f32 top-1 {ans[0]}")
    return model, bf16, main_counts, fused_counts


def throughput(model, bf16, dev, card, report):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 2, 100, 25, 3)).astype(np.float32)).to(dev)
    for name, m in (("f32", model), ("bf16", bf16)):
        with torch.inference_mode():
            for _ in range(2):
                out = m(x)
            torch.cuda.synchronize()
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                out = m(x)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
        check(out.shape == (64, 60) and bool(torch.isfinite(out).all()),
              f"{name} batch forward gave {tuple(out.shape)} / non-finite")
        clips = 64 / dt
        print(f"throughput {name}: batch (64, 2, 100, 25, 3) "
              f"{dt * 1e3:.3f} ms/forward, {clips:.1f} clips/s on {card}",
              flush=True)
        report["throughput"][name] = dict(ms_per_forward=dt * 1e3,
                                          clips_per_s=clips)
        breakdown(m, x, name, report)


def breakdown(model, x, name, report):
    """Device time of one batch forward by kernel (torch.profiler), the
    dynamic-graph kernels' share, and the device's idle share of the
    forward's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type.name == "CUDA":
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"profile {name}: the profiler saw no device time", flush=True)
        return
    ours = sum(r[0] for r in rows if "agg_kernel" in r[2]
               or "dyn_graph_fwd_kernel" in r[2])
    print(f"profile {name}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"wall (idle {1 - busy / wall_ms:.1%}, under the profiler); "
          f"dynamic-graph kernels {ours:.3f} ms ({ours / busy:.1%})",
          flush=True)
    for ms, count, key in rows[:12]:
        print(f"profile {name}: {ms:9.3f} ms {count:4d}x {key[:90]}",
              flush=True)
    report["profile"][name] = dict(
        wall_ms=wall_ms, busy_ms=busy, graph_kernels_ms=ours,
        top=[dict(ms=ms, count=c, kernel=k) for ms, c, k in rows[:25]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dsgcn_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    build_s = _build.build_all()
    print(f"kernel build: {json.dumps(build_s)} "
          f"({time.perf_counter() - t0:.1f} s wall)", flush=True)
    for name in _build.SIGNATURES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}", flush=True)

    report = dict(card=card, kernel_checks=[], serving=[], throughput={},
                  profile={})
    rng = np.random.default_rng(0)
    worst, per_forward = kernel_checks(dev, rng, report)
    model, bf16, main_counts, fused_counts = serve(dev, report)
    throughput(model, bf16, dev, card, report)

    sources = {
        "bd_dyn_graph_agg": ("dsgcn_tpu_torch/ops/kernels/csrc/bd_agg.cu",
                             "dsgcn_tpu/ops/pallas/bd_agg.py:170",
                             main_counts),
        "fused_dyn_graph_agg": (
            "dsgcn_tpu_torch/ops/kernels/csrc/dyn_graph.cu",
            "dsgcn_tpu/ops/pallas/dyn_graph.py:232", fused_counts),
    }
    kernels = []
    for name, (src, replaces, counts) in sources.items():
        pf = per_forward[name]
        check(counts[name] > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=worst[name], ms=pf["ms"],
            plain_ms=pf["plain_ms"], bound_ms=pf["bound_ms"],
            bound_by="/".join(sorted(pf["bound_by"])),
            library_ms=pf["library_ms"]))
    report["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    print("request latency ms (bf16): " + ", ".join(
        f"{ms:.3f}" for ms in report["request_ms"]["bf16"]))
    print(card)                  # name and power limit, as nvidia-smi has them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
