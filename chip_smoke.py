"""GPU smoke run of the PyTorch/CUDA port (``dsgcn_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``dsgcn_tpu_torch/ops/kernels/csrc``
and holds each against its plain PyTorch version on the card, in float32
and bfloat16; every timed kernel row also gives its time over the library
call's and over its bound.  DS-GCN: phase 2 checks K1 and K3 at its
serving shapes and times them with and without edge attention;
phases 3-5 serve full-width DS-GCN through ``init_recognizer`` /
``inference_recognizer`` (random seeded weights, gates nudged off zero, BN
statistics taken from data), check the kernels were launched on that path,
that the GPU answers match the same model on the CPU and that 'fused' and
'mega' (K6) agree with 'auto', and time a batch forward; phase 6 checks K2
and K1 at its training shapes (K2 also against autograd through the plain
forward; every case timed, with edge attention and without).  DG-STGCN
(the j config with ``model_cfg('dgstgcn')``): phase 8 checks K4 (and K1
at K4's blocks), K5, K6 (and K6 at DS-GCN's shapes with edge attention)
at its serving shapes and K2 at its training shapes, Cm = 64 included, and
times its GCN blocks per eval path (and DS-GCN's, 'auto' against 'mega');
K5 and K6 carry a second bound beside the CUDA-core one, their 1x1
products at the tensor cores' rate; phase 9 serves it (GPU against CPU, 7 K1 and
3 K4 launches per 'auto' forward, every ``eval_kernel`` option against
'auto' with its own launches, clips/s and profiles).  Phase 7 trains
DS-GCN (b128 x M2 x T60, synthetic data through the train pipeline and
the port's Loader): one step against the same step on the CPU, timed
steps in float32 and bfloat16 compute with their K1/K2 launches, one
``Trainer.validate`` (K3), and the training CLI with a checkpoint and a
resume; phase 10 takes the same batches through DG-STGCN's steps.
STGCN++ (the j config ``configs/stgcnpp/ntu60_xsub_3dkp/j.py`` with
``tcn_use_pallas=True``): phase 11 checks K7 at every temporal unit shape
of STGCN++ and DG-STGCN serving (with and without the pseudo-joint, stride
1 and 2) and times it beside the unfused region, with a second bound for
its products on tensor cores; phase 12 serves STGCN++
(10 K7 launches per forward, GPU against CPU, against the same weights
without K7, request latency, clips/s with and without K7); phase 13 serves
DG-STGCN and DS-GCN with K7 beside their GCN kernels; phase 14 trains
STGCN++ from its RepeatDataset train set (GPU step against CPU, timed
steps, no kernel launched).  Phase 15 takes every committed DS-GCN
config: K3, K1 and K2 on the COCO graph (V = 17 inside the joint bound 25)
at the hrnet block shapes, N = 64 and 160 (fight detection's 5 bodies),
against their plain versions; the j, b, jm and bm NTU configs through the
train (``--test-last``), test and fuse CLIs (10 K3 launches a forward,
scores against the CPU, the fusion against numpy); hrnet COCO serving
(kinetics400 j and b, fight detection j: DecompressPose, PoseCompact,
GPU against CPU, request latency, clips/s); and a COCO b training step
against the CPU with timed steps (K1 and K2 at V = 17).  Phase 16 takes
AAGCN and CTR-GCN (``configs/{aagcn,ctrgcn}/ntu60_xsub_3dkp/j.py`` and the
hrnet ``ntu60_xsub_hrnet/j.py``, V = 17), which have no kernel: serving
through init_recognizer / inference_recognizer (GPU against CPU on the
first request, request
latency, clips/s of a batch in f32 and bf16 with profiles), a training
step against the CPU and timed steps at the config's b16 x M2 x T100,
and CTR-GCN's j and b streams through the train, test and fuse CLIs; no
kernel of the port may launch on any of it.  Phase 17 takes the gesture
config (``configs/gesture/stgcnpp_hand.py``: STGCN++ on the 21-joint hand,
clip 10) serving with K7 (6 launches a forward) and without, GPU against
CPU, a b64 step against the CPU's, and K7 at V = 21 (T 10 and 5); the
ST-GCN and STGCN++ hrnet j configs (V = 17) serving, STGCN++ with K7 (10
a forward) and without, and K7 at V = 17; the train CLI without
``--validate`` on a config with ``data.val`` (a val record and a best
checkpoint, as JAX's CLI validates); DS-GCN's ``DGMSTCN`` eval layouts
(concat, which every layout runs, and K7) at b16 and b64 with busy and
idle time; DS-GCN and DG-STGCN steps at b128 under ``remat`` False, 'tcn' and True (loss and BN
statistics equal, K1 twice a block under True, peak memory); DS-GCN with
``target_specific`` (K3 and K1 serving, a K1 + K2 step),
``ada_attention`` and per-frame graphs ('NA', dense, at b16 with peak
memory).  Phase 18 takes serving export: calibrated full-width DS-GCN (f32
and bf16), DG-STGCN ('auto') and STGCN++ (K7) saved as checkpoints of the
port's trainer, exported through ``python -m dsgcn_tpu_torch.tools.export``
(four processes at once) and served with ``load_exported`` in a process
of their own (``--serve-artifacts``, which imports no model code): a
dynamic batch, the live module's logits (f32 within 1e-5; bf16 2e-3, top-1
equal) and kernel launches a forward (10 K3; 7 K1 + 3 K4; 10 K7), clips/s
of a (64, 2, 100, 25, 3) batch beside the live module's, ``predict``'s
latency, the export time; DS-GCN and DG-STGCN in joint-padded mode
(``to_padded_inference(v_pad=32)``, which runs at the real joints; f32
and bf16) against the model with the same launches; a pyskl-named
``.pth`` (``to_pyskl_state_dict``) through ``load_torch_checkpoint`` into
DS-GCN, the card against the CPU.  Phase 19 takes ``dsgcn_tpu_torch/
parallel`` through launches of ``python -m torch.distributed.run
--standalone`` (this script's ``--parallel-worker``): (a) the train CLI on
full-width DS-GCN (b128 x M2 x T60, three steps and the validation) in a
one-process NCCL launch, DDP at world size 1, against the plain trainer
from the same seed and batches (state within 1e-6), 10 K1 and 10 K2
launches a step and 10 K3 a validation forward, step ms and peak memory
beside the plain trainer's; (b) DDP over gloo, two processes on the one
card, b64 each, two steps: the two states equal, and equal to a reference
in this process that runs each half in train mode and averages gradients
and statistics by hand (loss and state within 1e-5); (c) in (a)'s process,
DS-GCN and DG-STGCN built with ``graph_axis`` on a (1, 1) mesh (the ring
of one hop) against the plain models at b16 (logits and a step's loss
within 1e-5, updates at cosine > 0.995, forward ms beside the plain
forward's); and which gloo collectives take CUDA tensors (recorded, not
checked; send and recv only under ``--parallel``, in a launch of their
own, since gloo's send of a CUDA tensor aborts the process).  Phase 20
takes the author's variants of the backbones, each seeded and calibrated
at full width: DS-GCN with ``tcn_type='dgmsmlp'`` (10 K3 launches a
forward), DG-STGCN with ``gcn_type='dghgcn'``, AAGCN with
``unit_aahgcn`` + ``unitmlp``, CTRGCN with ``unit_ctrhgcn`` asked for
msmlp (which CTRGCN, in JAX and the port, leaves to CTR-GCN's MSTCN) and
STGCN++ with msmlp and ``tcn_use_pallas`` (no K7 for mlp branches): GPU
logits against the CPU's, launches and ms of a (64, 2, 100, 25, 3)
forward beside the parent form's, a pyskl-named ``.pth`` round trip
(``to_pyskl_state_dict`` -> ``load_torch_checkpoint``), a train step
against the CPU's and timed steps (the dgmsmlp one at b128 x M2 x T60
with 10 K1 + 10 K2 launches, the others at b16 x M2 x T100, none);
feature extraction through the test CLI (``--feat-ext --pool-opt all``,
``tv``, ``--score-ext``, 10 K3 launches a backbone forward, float16
dumps against ``--device cpu``, TSNEmap and graph; the scores'
confusion matrix and mAP; a 1000-point t-SNE on the card); the NTU j
train pipeline with the native ``PreNormalize3D`` against the numpy path
(clips within 1e-6, ms per clip of each) and a ``class_prob`` epoch.
Phase 21 takes the other GCN families and the Granger-causality
learners, none of which has a kernel: MS-G3D and SGN
(``model_cfg('msg3d'|'sgn')``) served through init_recognizer /
inference_recognizer, GTGCN and STGIN recognizers, STGCN_GC fed a seeded
(3, 25, 25) external graph with a GCNHead, GCGCN and GCGCN_component with
a GCHead; each full-width, seeded, calibrated: GPU logits against the
CPU's, a (64, 2, T, 25, 3) batch forward (T 30 for SGN; MS-G3D and SGN
also in bf16) with its profile and peak memory, a train step against the
CPU's (the learners on ``gc_recognizer_losses``) and timed steps at b16
(STGIN at ``STGIN_TRAIN_BATCH``) with peak memory; no kernel of the port
may launch.  Phase 22 takes PoseC3D (``configs/posec3d/
slowonly_ntu60_xsub.py``: SlowOnly-R50 over 17-channel heatmap volumes,
no kernel) built through ``Config.fromfile`` and ``build_model`` with
seeded weights.  Serving, on the seeded model with BatchNorm statistics
from two videos' 10-clip test volumes (64 x 64): their batch forward and
clips/s, its logits against a CPU copy's (within 1e-3 of the largest,
and varying over clips and classes by ten times that), four videos
through the test CLI on the card, two of them on the CPU too (scores
within 1e-3, top-1 equal).  Training: synthetic hrnet annos through the
config's train pipeline and the Loader at b32 (clip_len 48, 56 x 56), a
step against the CPU's, timed f32 steps with peak memory and the host
pipeline's seconds a clip; the train CLI for two steps and a validation.
No kernel of the port may launch.  Phase 23 takes the DS-GCN j config
with a ReadoutNeck added in code (``cfg['model']['neck']``): served
through init_recognizer / inference_recognizer and a b64 x M2 x T100
batch forward (10 K3 launches a forward; each row's prototype on the card
against a CPU copy's, flips counted, logits within 1e-3 where none
flipped), its ``train_step``, the ``gcnr_losses`` step and a masked
pretraining step (PretrainNeck(256, 25), ``pretrain_losses``) at b128 x
M2 x T60 (10 K1 and 10 K2 launches a backbone pass), each against the
CPU's; then SparseSTGCN, SparseCTRGCN and SparseSTGCNExact at their
defaults with a linear head, up a sparsity ramp at b16 x M2 x T100 with
``make_sparse_optimizer`` and ``group_lasso_penalty`` (each threshold pool
keeps 1 - sparsity within 0.05, the masks equal a CPU copy's, a step
against the CPU's, float32 but SparseCTRGCN's float64; no kernel).
Phase 24 takes the rest of sparse training: (a) SparseAAGCN (NTU spatial
graph) and SparseDGSTGCN (the random K = 8 graph, seeded) at their
defaults with a linear head, and (b) AssembleSparse over ST-GCN, AA-GCN,
CTR-GCN and DG-GCN on the random K = 8 graph (two subsets a branch,
``assemble_regularize`` as the penalty), each up the sparsity ramp as
phase 23's backbones (pools within 0.05, masks equal a CPU copy's, a
float64 step against the CPU's: their gates start at 0); (c)
SMoEAssembleSparse over routed ST-GCN, AA-GCN, CTR-GCN and DG-GCN experts
and an ST-GCN base (k = 1, noisy gating, ``w_gate`` and ``w_noise``
drawn off 0), a ClsHead of 60 classes and ``smoe_recognizer_losses`` with
``smoe_regularize``: a float64 step against the CPU with the same
injected gate noise, b16 x M2 x T100 steps inside and past the warm-up
with noise from a generator on the card (the experts each step routed
to), an eval forward (clips/s, logits against a CPU copy within 1e-3,
the same routing); (d) expert parallelism: two gloo processes on cuda:0
(phase 19's launcher), rank e running routed expert e of a full-width
SMoE of three ST-GCN backbones, each rank's feature and balance loss
within 1e-5 of the dense SMoE on the card.  No kernel of the port
launches in phase 24 (the ranks count theirs too).  Phase 25 takes the
3D-CNN, video and multimodal models, each built through ``build_model``
from a config written here, seeded, with BatchNorm statistics from its
own batch: (a) ``MMRecognizer3D(RGBPoseConv3D, RGBPoseHead(60, (2048,
512)))`` at the backbone's fixed widths, fed b8 of synthetic hrnet annos
with a seeded frame array through the multimodal pipeline (RGB 8 x 224
x 224, heatmaps 32 x 56 x 56), its step on ``mm_cross_entropy``; (b)
X3D-shallow and C3D-light (pyskl's PoseC3D variants, ``Recognizer3D`` +
``I3DHead``) and ``Recognizer2D(PoTion)`` + ``TSNHead`` over
``Heatmap2Potion(C=3, 'full')`` images, fed b32 from PoseC3D's train
pipeline (48 x 56 x 56), X3D and C3D through the train CLI (two steps
and a validation), X3D's seeded model through the test CLI on two videos
on the card, with ``--bf16`` (2e-3 of f32) and on ``--device cpu`` (1e-3,
top-1 equal); (c) SlowFast-R50 (JAX's defaults, 32 frames at 224) from
``VideoDataset`` rawframe lines over JPEG frames through the train
pipeline and the Loader at b8, and a ThreeCrop test batch folded as the
test CLI folds clips.  Each: GPU logits against a CPU copy's on one
sample (1e-3 of the largest; the card's logits varying over samples and
classes by 1e-2 of the largest), a float64 step against the CPU's,
timed f32 steps and a batch forward with clips/s, peak GiB, busy and idle
and the top device operations.  No kernel of the port launches in phase
25.  The whole run writes each phase's
finish time (seconds from the first phase's start) under
``phase_done_s`` in ``chiprun_out/chip_smoke.json``.
Phases run in the order 2-6, 8, 9, 11-13, 7, 10, 14, 15, 16, 17, 18, 19,
20, 21, 22, 23, 24, 25;
``--every-config`` runs 15 alone, ``--families`` 16 alone
(``chiprun_out/families.json``), ``--options`` 17 alone
(``chiprun_out/options.json``), ``--serving`` 18 alone
(``chiprun_out/serving.json``), ``--parallel`` 19 alone
(``chiprun_out/parallel.json``), ``--extras`` 20 alone
(``chiprun_out/extras.json``), ``--other-families`` 21 alone
(``chiprun_out/other_families.json``), ``--posec3d`` 22 alone
(``chiprun_out/posec3d.json``), ``--readouts`` 23 alone
(``chiprun_out/readouts.json``), ``--smoe`` 24 alone
(``chiprun_out/smoe.json``), ``--video`` 25 alone
(``chiprun_out/video.json``).  Any failed check raises, and the script
exits non-zero without a result line.
The kernel checks of phases 2, 6, 8 and 15 draw their random inputs on
the card (one torch.Generator, seed 0).  A bfloat16 output of K1 (phases 8
and 15) or K4 (phase 8) may lie outside the elementwise bound only where
one graph entry that rounds to bfloat16 the other way explains it
(``graph_flips``).  ``--kernel-seeds N`` runs those checks alone and then
K4's bfloat16 cases over N more draws (``k4_seeds``,
``chiprun_out/kernel_seeds.json``).
``python3 chip_smoke.py --sweep`` runs none of these: it times K1 and K3
under the block plans near their planner's at the main paths' shapes
(``plan_sweep``) and writes ``chiprun_out/agg_sweep.json``;
``--sweep-blocks`` does the same for K5 and K6 (``block_sweep``) and K7
(``k7_sweep``: the plans its cost model ranks next to the planner's), into
``chiprun_out/block_sweep.json``; ``--blocks`` runs phase 8's K5 and K6
checks, the block times and phase 11's K7 checks and times alone
(``chiprun_out/blocks.json``).  ``--parent DIR`` times
the K5, K6 and K7 of another checkout of the port (a ``git archive`` of
the parent commit unpacked into DIR) beside these, in turns, in phases 8
and 11 (and checks that K5's and K6's outputs have the parent's bits).
Every run first counts the tensor-core instructions in K5's, K6's and
K7's SASS (``cuobjdump -sass``) and fails without them.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it lists the kernels with their launches, errors and
times.  Per-shape kernel numbers also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import json
import pathlib
import pickle
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
THROUGHPUT_BATCH = (64, 2, 100, 25, 3)    # clips, bodies, frames, joints, xyz
# DS-GCN training at b128 x M2 x T60 (N=256 skeletons): (mid, T at the GCN,
# blocks with this shape)
TRAIN_BLOCK_SHAPES = [(8, 60, 4), (16, 60, 1), (16, 30, 2), (32, 30, 1),
                      (32, 15, 2)]
N_TRAIN = 256
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


def with_ratios(row):
    """The kernel's time over the library call's and over its bound, on
    its row (``row`` holds ms, library_ms and bound_ms)."""
    lib = row.get("library_ms")
    row.update(ms_over_library=row["ms"] / lib if lib else None,
               ms_over_bound=row["ms"] / row["bound_ms"])
    return row


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at the block shapes
# ---------------------------------------------------------------------------

def block_inputs(rng, dev, Cm, T, dtype, Vp=V, v_real=-1, N=N_BLOCK, K=K,
                 layout="nturgb+d"):
    """K1 and K3 inputs of one DS-GCN (K = 3) or DG-STGCN (K = 8) block's
    aggregation (random, drawn on ``dev`` from the torch.Generator ``rng``,
    with the layout's edge classes, padded to Vp)."""
    from dsgcn_tpu_torch.graph import Graph
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import edge_onehot
    f = lambda *s: torch.randn(s, generator=rng, device=dev)  # noqa
    d = dict(pre=f(N, T, Vp, K * Cm).to(dtype), x1=f(N, K, Cm, Vp),
             x2=f(N, K, Cm, Vp), A=f(K, Vp, Vp) * 0.04,
             alpha=f(K).clamp(-1, 1), beta=f(K).clamp(-1, 1),
             ew=f(Cm, E * Cm) * 0.2, eb=f(E * Cm) * 0.1)
    sel = edge_onehot(Graph(layout=layout, mode="spatial").edge_type, E)
    pad = Vp - sel.shape[-1]
    sel = np.pad(sel, ((0, 0), (0, pad), (0, pad)))
    d["sel"] = torch.from_numpy(sel).to(dev)
    if v_real > 0:   # padded joints: zero values, as JAX pads them
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
    K = d["A"].shape[0]
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
    K = d["A"].shape[0]
    keys = (["pre", "x1", "x2", "A", "alpha", "beta"]
            + (["ew", "eb", "sel"] if edge else [])
            if name == "fused_dyn_graph_agg" else
            ["pre2", "x1t", "x2", "A", "alpha", "beta"]
            + (["p1t", "p2", "sel", "ebias"] if edge else []))
    # K4 (bd_dyn_graph_agg_subset) reads K3's inputs without the edge ones
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
            row = dict(kernel=name, Cm=Cm, T=T, N=N_BLOCK, V=Vp,
                       v_real=v_real, dtype=str(dtype).split(".")[-1],
                       edge=edge)
            err = compare(name, kern(), plain(), dtype, row)
            worst[name] = max(worst.get(name, 0.0), err)
            if Vp == V:
                # time the path's own configuration (edge attention on
                # subset 1) and, beside it, the same shape without it
                ms = cold_ms(kern, flush=flush)
                plain_ms = cold_ms(plain, iters=3, flush=flush)
                library_ms = cold_ms(library, flush=flush)
                bound_ms, bound_by = bound(d, name, Cm, edge)
                row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           blocks_per_forward=nblocks)
                with_ratios(row)
                if dtype == torch.float32 and edge:
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
# phase 6: K2 (the backward kernel) against its plain version
# ---------------------------------------------------------------------------

K2_OUTPUTS = ("dpre", "dx1", "dx2", "dA", "dalpha", "dbeta", "dedge_w",
              "dedge_b")
# relative to each output's largest entry: summation order in float32 (the
# gradients are float32 in both types); a bfloat16 dpre is one rounding of
# the same float32 sum (2^-8), doubled
K2_TOL, K2_TOL_BF16_DPRE = 1e-4, 8e-3


def compare_k2(got, refs, dtype, row):
    """Hold K2's gradients against each reference (the plain backward,
    autograd): each within K2_TOL of its largest entry, a bf16 dpre within
    K2_TOL_BF16_DPRE.  Records the relative errors and the max abs error
    against the plain backward in ``row``."""
    torch.cuda.synchronize()
    row.update(rel_err={}, max_abs_err=0.0)
    for ref_name, ref in refs.items():
        for out, g, w in zip(K2_OUTPUTS, got, ref):
            if w is None:
                check(g is None, f"K2 gave {out} without edge")
                continue
            check(bool(torch.isfinite(g.float()).all()),
                  f"K2 {out} not finite at {row}")
            err = (g.float() - w.float()).abs().max().item()
            rel = err / max(w.float().abs().max().item(), 1e-30)
            tol = (K2_TOL_BF16_DPRE if out == "dpre"
                   and dtype == torch.bfloat16 else K2_TOL)
            row["rel_err"][f"{ref_name}:{out}"] = rel
            if ref_name == "plain":
                row["max_abs_err"] = max(row["max_abs_err"], err)
            check(rel <= tol, f"K2 {out} off its {ref_name} reference by "
                  f"{rel:.3e} rel (tol {tol}) at {row}")


def k2_args(d, Cm, edge):
    ek = 1 if edge else -1
    return ((d["pre"], d["x1"], d["x2"], d["A"], d["alpha"], d["beta"])
            + ((d["ew"], d["eb"], d["sel"]) if edge else (None, None, None))
            + (d["dy"], d["A"].shape[0], Cm, ek, E))


def k2_refs(d, args, Cm, edge, dtype):
    """K2's references: its plain version and, in float32, torch.autograd
    through the plain forward (phase 6's)."""
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
        reference_dyn_graph_agg, reference_dyn_graph_agg_bwd)
    refs = {"plain": reference_dyn_graph_agg_bwd(*args)}
    if dtype == torch.float32:
        ins = [a.detach().requires_grad_() for a in args[:8]
               if a is not None]
        full = ins[:6] + (ins[6:] + [d["sel"]] if edge
                          else [None, None, None])
        with torch.enable_grad():
            y = reference_dyn_graph_agg(*full, K=d["A"].shape[0], Cm=Cm,
                                        edge_k=1 if edge else -1, edge_num=E)
            auto = torch.autograd.grad(y, ins, d["dy"])
        refs["autograd"] = list(auto[:6]) + (list(auto[6:]) if edge
                                             else [None, None])
    return refs


def k2_bound(d, Cm, edge):
    """Least time of K2's work (ms) and what bounds it: pre and dy read and
    dpre written once, plus the small operands and gradients, over the
    memory rate, against the two T-contractions and the graph chain in
    float32 over the CUDA-core rate."""
    N, T, Vp, KC = d["pre"].shape
    K = d["A"].shape[0]
    act = d["pre"].numel() * d["pre"].element_size()
    small = sum(d[k].numel() * 4 for k in
                ["x1", "x2", "A", "alpha", "beta"]
                + (["ew", "eb", "sel"] if edge else []))
    grads = (2 * d["x1"].numel() + d["A"].numel() + 2 * K
             + ((d["ew"].numel() + d["eb"].numel()) if edge else 0)) * 4
    nbytes = 3 * act + small + grads
    flops = 4 * N * T * Vp * Vp * KC                    # dpre and dG
    flops += N * K * 12 * Cm * Vp * Vp                  # graph, chain, ada
    if edge:
        flops += N * Cm * Vp * Vp * 4 * E               # edge ctr and dP
        flops += N * 8 * Cm * E * Cm * Vp               # P, dx, dedge_w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k2_checks(dev, rng, report):
    """K2 at the five DS-GCN training block shapes (N=256), f32 and bf16,
    with and without edge attention: against the plain backward, and in
    f32 also against torch.autograd through the plain forward; every case
    timed.  The per-step sums take the path's (edge attention on subset 1);
    those without it go to ``report['k2_per_step_no_edge']``."""
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import fused_dyn_graph_agg_bwd
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    worst = {"fused_dyn_graph_agg": 0.0, "fused_dyn_graph_agg_bwd": 0.0}
    per_step = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                           bound_ms=0.0, bound_by=set()) for name in worst}
    no_edge = {name: new_sum() for name in worst}
    for Cm, T, nblocks in TRAIN_BLOCK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for edge in (True, False):
                d = block_inputs(rng, dev, Cm, T, dtype, N=N_TRAIN)
                d["dy"] = torch.randn(d["pre"].shape, generator=rng,
                                      device=dev).to(dtype)
                args = k2_args(d, Cm, edge)
                got = fused_dyn_graph_agg_bwd(*args)
                refs = k2_refs(d, args, Cm, edge, dtype)
                row = dict(kernel="fused_dyn_graph_agg_bwd", Cm=Cm, T=T,
                           N=N_TRAIN, dtype=str(dtype).split(".")[-1],
                           edge=edge)
                compare_k2(got, refs, dtype, row)
                worst[row["kernel"]] = max(worst[row["kernel"]],
                                           row["max_abs_err"])
                rows = [row]
                row.update(k2_times(d, args, Cm, flush))
                with_ratios(row)
                # K1 at the same shape, with the path's edge attention and
                # without it
                rows.append(k1_at_training_shape(d, Cm, dtype, flush, edge))
                worst[rows[1]["kernel"]] = max(
                    worst[rows[1]["kernel"]], rows[1]["max_abs_err"])
                for r in rows:
                    r["blocks_per_step"] = nblocks
                    if dtype == torch.float32:
                        add_to(per_step[r["kernel"]] if edge
                               else no_edge[r["kernel"]], r, nblocks)
                    report["k2_checks"].append(r)
                    print("kernel", json.dumps(r), flush=True)
                del d, got, refs
    report["k2_per_step_no_edge"] = no_edge
    print("K1/K2 per DS-GCN step without edge attention: "
          + json.dumps(no_edge, default=sorted), flush=True)
    return worst, per_step


def k1_at_training_shape(d, Cm, dtype, flush, edge=True):
    """K1's forward against its plain version (``compare``; in bfloat16,
    41-82M outputs at DG-STGCN's shapes, with ``graph_flips``) and timed
    at a training block shape (the forward of the step K2
    differentiates)."""
    kern, plain, library = kernel_calls(d, Cm, edge)["fused_dyn_graph_agg"]
    row = dict(kernel="fused_dyn_graph_agg", Cm=Cm, T=d["pre"].shape[1],
               N=N_TRAIN, K=d["A"].shape[0], dtype=str(dtype).split(".")[-1],
               edge=edge)
    compare(row["kernel"], kern(), plain(), dtype, row,
            graph_flips(d, Cm, edge) if dtype == torch.bfloat16 else None)
    bound_ms, bound_by = bound(d, "fused_dyn_graph_agg", Cm, edge)
    row.update(ms=cold_ms(kern, flush=flush),
               plain_ms=cold_ms(plain, iters=3, flush=flush),
               library_ms=cold_ms(library, flush=flush), bound_ms=bound_ms,
               bound_by=bound_by)
    return with_ratios(row)


def k2_times(d, args, Cm, flush):
    """K2's device time, its plain version's, and the library yardstick:
    the two einsums that compute dpre and dG from a prebuilt graph."""
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
        fused_dyn_graph_agg_bwd, reference_dyn_graph_agg_bwd)
    N, T, Vp, _ = d["pre"].shape
    K = d["A"].shape[0]
    G = torch.randn(N, K, Cm, Vp, Vp, device=d["pre"].device).to(
        d["pre"].dtype)
    pre5 = d["pre"].reshape(N, T, Vp, K, Cm)
    dy5 = d["dy"].reshape(N, T, Vp, K, Cm)

    def library():
        torch.einsum("ntwkc,nkcvw->ntvkc", dy5, G)
        torch.einsum("ntvkc,ntwkc->nkcvw", pre5, dy5)
    bound_ms, bound_by = k2_bound(d, Cm, args[6] is not None)
    return dict(ms=cold_ms(lambda: fused_dyn_graph_agg_bwd(*args),
                           flush=flush),
                plain_ms=cold_ms(lambda: reference_dyn_graph_agg_bwd(*args),
                                 iters=3, flush=flush),
                library_ms=cold_ms(library, flush=flush),
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 7: training through the entry points
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_STEPS = 128, 3     # videos per step; timed steps per dtype
CPU_CHECK_CLIPS = 4


def nudge_gates_(model, gen):
    """Gates and joint coefficients off zero, so the ctr/ada graphs and the
    global-joint branch carry gradient from the first step."""
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("alpha", "beta", "add_coeff"):
                t.uniform_(-0.3, 0.3, generator=gen)


def nudge_units_(model, gen):
    """AAGCN's and CTR-GCN's units off their initial values: the
    attention's zero-initialised convs (``conv_ta``, ``fc2c``) and each
    unit's closing BN scale (1e-6), at which the units' inner gradients
    are rounding noise (a float32 step on the CPU is as far from a
    float64 one there as from the card's)."""
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith(("conv_ta.weight", "fc2c.weight")):
                t.uniform_(-0.1, 0.1, generator=gen)
            elif name.endswith("gcn.bn.weight"):
                t.uniform_(0.2, 0.4, generator=gen)


def train_data(tmp, cfg, seed=0):
    """Synthetic NTU-shaped annotations (T=100 raw frames, 60 classes)
    through the config's train and val pipelines and the port's Loader."""
    from dsgcn_tpu_torch.data.dataset import (Loader, PoseDataset,
                                              make_synthetic_pose_dataset)
    path = str(tmp / "synth.pkl")
    # the train split (the first 3/4) holds 1 + TRAIN_STEPS batches
    need = (1 + TRAIN_STEPS) * TRAIN_BATCH
    n = -(-need * 4 // 3)
    make_synthetic_pose_dataset(num_samples=n, num_classes=60, t=100,
                                seed=seed, path=path)
    data = cfg["data"]
    train = Loader(PoseDataset(path, data["train"]["pipeline"],
                               split="train"),
                   batch_size=TRAIN_BATCH, seed=seed, drop_last=True,
                   num_workers=8)
    val = Loader(PoseDataset(path, data["val"]["pipeline"], split="val",
                             test_mode=True),
                 batch_size=data["test_dataloader"]["videos_per_gpu"],
                 shuffle=False, num_workers=8)
    return train, val


def as_batch(b, n=None):
    kp = b["keypoint"][:, 0]              # (N, nc=1, M, T, V, C) -> one clip
    return dict(keypoint=kp[:n], label=b["label"][:n])


def scores_of(out):
    """A recognizer's logits as a dict ({'rgb', 'pose'} or {'logits'})."""
    return out if isinstance(out, dict) else {"logits": out}


def model_inputs(batch):
    """The model's inputs in a batch: ``imgs`` and ``heatmap_imgs`` (a
    multimodal batch), else its ``keypoint`` or ``imgs``."""
    from dsgcn_tpu_torch.core.train import input_key
    keys = (("imgs", "heatmap_imgs") if "heatmap_imgs" in batch
            else (input_key(batch),))
    return [torch.as_tensor(batch[k]) for k in keys]


def gpu_vs_cpu_step(model, batch, out, step=None):
    """One train_step (or ``step``, of train_step's signature) on the card
    and the same step on the CPU (plain versions) from the same weights and
    batch: loss within 1e-4, train-mode logits (each stream's) within 1e-3
    relative, each parameter's update with cosine > 0.995 and norm within
    5% (float32 rounding grows through the untrained BatchNorm stacks;
    tests/test_training_dynamics_parity.py)."""
    from dsgcn_tpu_torch.core.train import make_optimizer, train_step
    step = step or train_step
    model = copy.deepcopy(model)          # the caller's model stays as it is
    cpu = copy.deepcopy(model).cpu()
    init = {k: v.detach().cpu().clone() for k, v in cpu.state_dict().items()}
    xs = model_inputs(batch)
    logits = []
    for m in (model, cpu):
        probe = copy.deepcopy(m).train()
        d = next(m.parameters()).device
        with torch.no_grad():
            logits.append({k: v.cpu() for k, v in scores_of(
                probe(*[x.to(d) for x in xs])).items()})
    losses = []
    for m in (model, cpu):
        opt, sched = make_optimizer(m, 10)
        losses.append(step(m, opt, sched, batch)["loss"].item())
    lerr = max(rel_err(logits[0][k], logits[1][k]) for k in logits[1])
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    worst_cos, worst_ratio, worst_name = 1.0, 0.0, None
    gpu_state = model.state_dict()
    for name, p in cpu.named_parameters():
        du_c = (p.detach() - init[name]).ravel()
        du_g = (gpu_state[name].cpu() - init[name]).ravel()
        cos = (du_g @ du_c / (du_g.norm() * du_c.norm())).item()
        if cos < worst_cos:
            worst_cos, worst_name = cos, name
        worst_ratio = max(worst_ratio,
                          abs((du_g.norm() / du_c.norm()).item() - 1))
    row = dict(loss_gpu=losses[0], loss_cpu=losses[1], loss_rel_err=loss_err,
               logits_rel_err=lerr, worst_update_cos=worst_cos,
               worst_update_param=worst_name,
               worst_update_norm_ratio_err=worst_ratio)
    print("train gpu vs cpu", json.dumps(row), flush=True)
    out["gpu_vs_cpu"] = row
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(loss_err <= 1e-4, f"GPU loss off the CPU's by {loss_err:.3e} rel")
    check(lerr <= 1e-3, f"GPU logits off the CPU's by {lerr:.3e} rel")
    check(worst_cos > 0.995 and worst_ratio < 5e-2,
          f"GPU update off the CPU's: cosine {worst_cos}, norm {worst_ratio}")


def timed_steps(model, batches, dtype_name, card, out, per_step):
    """Full-size steps: one warm-up, then TRAIN_STEPS timed ones, each with
    its loss, wall ms, clips/s, peak device memory and kernel launches,
    which must be ``per_step`` (launches per step by wrapper; every other
    kernel none)."""
    from dsgcn_tpu_torch.core.train import make_optimizer, train_step
    compute = None if dtype_name == "f32" else "bfloat16"
    opt, sched = make_optimizer(model, 100)
    rows = []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        t0 = time.perf_counter()
        m = train_step(model, opt, sched, b, compute_dtype=compute)
        loss = m["loss"].item()            # synchronizes
        wall = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        launches = {k: after[k] - before[k] for k in after}
        row = dict(dtype=dtype_name, step=i, warmup=i == 0, loss=loss,
                   wall_ms=wall, clips_per_s=len(b["label"]) / wall * 1e3,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=launches)
        print("train step", json.dumps(row), f"on {card}", flush=True)
        check(np.isfinite(loss), f"non-finite loss at {row}")
        expect_counts(launches, per_step, 1, f"a {dtype_name} step")
        rows.append(row)
    out["steps"].extend(rows)
    # one more step of the same kind under the profiler
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, sched, batches[-1], compute_dtype=compute)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out.setdefault("profile", {})[dtype_name] = device_rows(
        prof, wall, f"train profile {dtype_name}")


def train_cli(tmp, report):
    """The CLI, one short epoch on a synthetic pickle, twice: the second run
    resumes from the first one's checkpoint."""
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    ann = tmp / "cli.pkl"
    make_synthetic_pose_dataset(num_samples=64, num_classes=60, t=100, seed=5,
                                path=str(ann))
    cfg = tmp / "cli_cfg.py"
    cfg.write_text(f"_base_ = [{str(CONFIG)!r}]\n"
                   f"data = dict(videos_per_gpu=16, workers_per_gpu=4,\n"
                   f"    train=dict(ann_file={str(ann)!r}, split='train'),\n"
                   f"    val=dict(ann_file={str(ann)!r}, split='val'))\n"
                   "checkpoint_config = dict(interval=1)\n")
    wd = tmp / "wd"
    for epochs in (1, 2):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "dsgcn_tpu_torch.tools.train", str(cfg),
             "--work-dir", str(wd), "--validate", "--total-epochs",
             str(epochs)], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        print(f"train CLI, {epochs} epoch(s): rc {out.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in out.stdout.splitlines()[-4:]:
            print(f"  cli: {line}", flush=True)
        check(out.returncode == 0, f"train CLI failed:\n{out.stderr[-3000:]}")
    ckpts = sorted(p.name for p in (wd / "ckpt").glob("*.pt"))
    records = [json.loads(line) for f in sorted(wd.glob("*.log.jsonl"))
               for line in f.read_text().splitlines()]
    resumed = [r for r in records if r.get("event") == "resume"]
    print(f"train CLI checkpoints {ckpts}, resumed {resumed}", flush=True)
    check(ckpts == ["3.pt", "6.pt"], f"CLI checkpoints {ckpts}")
    check(len(resumed) == 1 and resumed[0]["step"] == 3,
          f"the second CLI run did not resume from step 3: {resumed}")
    report["train"]["cli"] = dict(checkpoints=ckpts, resumed=resumed)


def train(dev, card, report):
    """Phases 7 and 10, on the same synthetic batches.  Returns the kernel
    counts of DS-GCN's training path (the full size steps, f32 then bf16
    compute, and one Trainer.validate)."""
    import tempfile
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.trainer import Trainer
    from dsgcn_tpu_torch.models.builder import build_model

    cfg = Config.fromfile(str(CONFIG))
    check(cfg["data"]["videos_per_gpu"] == TRAIN_BATCH
          and cfg["clip_len"] == 60, "the j config is not b128 x T60")
    report["train"] = dict(steps=[])
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        model = build_model(cfg["model"])
        nudge_gates_(model, torch.Generator().manual_seed(7))
        check(model.backbone.num_blocks == 10, "DS-GCN has not 10 blocks")
        train_loader, val_loader = train_data(tmp, cfg)
        # the trainer draws the conv and head weights from its seed and
        # moves the model to the card
        trainer = Trainer(model, str(tmp / "trainer"), train_loader,
                          val_loader, seed=7, device=dev,
                          eval_metrics=cfg["evaluation"]["metrics"])
        model = trainer.model
        batches = [as_batch(b) for b in train_loader.epoch(0)]
        check(len(batches) == 1 + TRAIN_STEPS, f"{len(batches)} batches")
        cpu_batch = as_batch(next(train_loader.epoch(1)), CPU_CHECK_CLIPS)
        gpu_vs_cpu_step(model, cpu_batch, report["train"])

        reset_counts()
        k1k2 = {"fused_dyn_graph_agg": 10, "fused_dyn_graph_agg_bwd": 10}
        timed_steps(model, batches, "f32", card, report["train"], k1k2)
        timed_steps(model, batches, "bf16", card, report["train"], k1k2)
        t0 = time.perf_counter()
        val = trainer.validate()
        val_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        print("train path launches", json.dumps(counts), flush=True)
        print(f"validate: {json.dumps(val)} in {val_ms:.1f} ms "
              f"({len(val_loader.dataset)} clips)", flush=True)
        n_val = -(-len(val_loader.dataset) // val_loader.batch_size)
        check(all(np.isfinite(v) for v in val.values()),
              f"validation gave {val}")
        check(counts["bd_dyn_graph_agg"] == 10 * n_val,
              f"validate launched K3 {counts['bd_dyn_graph_agg']} times for "
              f"{n_val} batches")
        report["train"].update(validate=val, validate_ms=val_ms)
        train_cli(tmp, report)
        del model, trainer
        train_dgstgcn(dev, card, report, batches, cpu_batch)
    return counts


def train_dgstgcn(dev, card, report, batches, cpu_batch):
    """Phase 10: DG-STGCN (the j config with model_cfg('dgstgcn')) through
    train_step on the same batches: one GPU step against the CPU's, then
    timed full-size steps in float32 and bfloat16 compute, each launching
    K1 and K2 once per block, with their peak device memory."""
    from dsgcn_tpu_torch.models.builder import init_weights_

    gen = torch.Generator().manual_seed(8)
    model = init_weights_(build_dgstgcn(), gen)
    nudge_gates_(model, gen)
    model = model.to(dev)
    out = report["dgstgcn_train"] = dict(steps=[])
    gpu_vs_cpu_step(model, cpu_batch, out)
    k1k2 = {"fused_dyn_graph_agg": 10, "fused_dyn_graph_agg_bwd": 10}
    timed_steps(model, batches, "f32", card, out, k1k2)
    timed_steps(model, batches, "bf16", card, out, k1k2)


# ---------------------------------------------------------------------------
# phase 8: DG-STGCN's kernels against their plain versions
# ---------------------------------------------------------------------------

# DG-STGCN (model_cfg('dgstgcn'): K = 8 subsets, ratio 0.25) at
# b64 x M2 x T100: (C in, C out, mid, T at the GCN) of its ten blocks;
# DS-GCN's ten blocks for K6 (K = 3, edge attention on subset 1)
DG_K = 8
DG_BLOCKS = ([(3, 64, 16, 100)] + [(64, 64, 16, 100)] * 3
             + [(64, 128, 32, 100)] + [(128, 128, 32, 50)] * 2
             + [(128, 256, 64, 50)] + [(256, 256, 64, 25)] * 2)
DS_BLOCKS = ([(3, 64, 8, 100)] + [(64, 64, 8, 100)] * 3
             + [(64, 128, 16, 100)] + [(128, 128, 16, 50)] * 2
             + [(128, 256, 32, 50)] + [(256, 256, 32, 25)] * 2)
# DG-STGCN training at b128 x M2 x T60: (mid, T at the GCN, blocks)
DG_TRAIN_BLOCK_SHAPES = [(16, 60, 4), (32, 60, 1), (32, 30, 2), (64, 30, 1),
                         (64, 15, 2)]


def distinct(blocks):
    """[(shape, how many blocks have it)] in first-seen order."""
    counts = {}
    for b in blocks:
        counts[b] = counts.get(b, 0) + 1
    return list(counts.items())


def compare(name, got, want, dtype, row, flips=None):
    """Hold a kernel's output against its plain version: each element
    within TOL of itself (rtol = atol = TOL).  With ``flips`` (a bfloat16
    output over a bfloat16-rounded graph, see ``graph_flips``) at most
    MAX_FLIPS elements may lie outside that bound, each within its own
    bound for one graph entry rounded the other way.  Records how many
    elements are outside the elementwise bound; returns the max abs
    error."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    tol = TOL[dtype]
    off = ~torch.isclose(got.float(), want.float(), rtol=tol, atol=tol)
    outside = int(off.sum().item())
    ok = outside == 0
    if flips is not None and 0 < outside <= MAX_FLIPS:
        row["flips"] = flips(got, want, off, tol)
        ok = all(f["explained"] for f in row["flips"])
    row.update(max_abs_err=err, max_abs_ref=ref, tol=tol, ok=ok,
               outside_elementwise=outside)
    check(bool(torch.isfinite(got.float()).all()),
          f"{name} non-finite output at {row}")
    check(got.dtype == want.dtype, f"{name} returned {got.dtype}")
    check(ok, f"{name} disagrees with its plain version: {row}")
    return err


# bfloat16 outputs of K1 that may lie outside the elementwise bound, each
# explained by one graph entry that rounds the other way (graph_flips)
MAX_FLIPS = 10


def graph_flips(d, Cm, edge, v_real=-1):
    """``compare``'s check of K1's bfloat16 outputs outside the elementwise
    bound.  Both versions build the graph G in float32, in different
    orders, and round it to bfloat16: an entry G[c, v, w] within a float32
    ulp or so of a bfloat16 rounding midpoint can round up in one and down
    in the other, which moves y[t, w, c] by pre[t, v, c] times a bfloat16
    ulp of G.  For each such output this records the entry whose flip
    explains the error best (its float32 value, both roundings, its
    distance from the midpoint in float32 ulps, pre) and holds the error
    to TOL plus the largest |pre[t, v, c]| x ulp(G[c, v, w]) over v.  K4
    builds the same G (its output viewed as (N, T, V, K*Cm));
    ``v_real`` masks padded sources of the ada softmax."""
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import _ctr, _graph
    edge_args = (d["ew"], d["eb"], d["sel"]) if edge else (None,) * 3

    def explain(got, want, off, tol):
        out = []
        for n, t, w, kc in off.nonzero().tolist():
            k, c = divmod(kc, Cm)
            x1, x2 = d["x1"][n:n + 1].float(), d["x2"][n:n + 1].float()
            ctr = _ctr(x1, x2, *edge_args, Cm, 1 if edge else -1, E)
            g = _graph(x1, x2, d["A"], d["alpha"], d["beta"], ctr,
                       v_real)[0][0, k, c, :, w]            # over sources v
            gb = g.to(torch.bfloat16).float()
            ulp = torch.exp2(torch.floor(torch.log2(
                gb.abs().clamp_min(1e-30))) - 7)
            other = gb + torch.where(g >= gb, ulp, -ulp)
            pre = d["pre"][n, t, :, kc].float()
            e = (got[n, t, w, kc].float() - want[n, t, w, kc].float()).item()
            v = int((pre * (other - gb) - e).abs().argmin())
            f32_ulp = torch.exp2(torch.floor(torch.log2(
                g[v].abs().clamp_min(1e-30))) - 23)
            limit = (tol * (1 + abs(want[n, t, w, kc].float().item()))
                     + (pre.abs() * ulp).max().item())
            out.append(dict(
                at=[n, t, w, kc], got=got[n, t, w, kc].float().item(),
                want=want[n, t, w, kc].float().item(), err=e, v=v,
                G_f32=g[v].item(), G_bf16=gb[v].item(),
                G_other=other[v].item(),
                from_midpoint_f32_ulps=(
                    (g[v] - (gb[v] + other[v]) / 2).abs() / f32_ulp).item(),
                pre=pre[v].item(), flip=(pre[v] * (other[v] - gb[v])).item(),
                limit=limit, explained=abs(e) <= limit))
        return out
    return explain


def compare_k4(got, want, d, Cm, v_real, dtype, row):
    """``compare`` for K4: its (N, T, V*K*Cm) output viewed as K1's (N, T,
    V, K*Cm), and bfloat16 outputs outside the elementwise bound held to
    ``graph_flips``' rule (K4 rounds the float32 graph to bfloat16 for the
    contraction as K1 does)."""
    shape = d["pre"].shape
    return compare("bd_dyn_graph_agg_subset", got.reshape(shape),
                   want.reshape(shape), dtype, row,
                   graph_flips(d, Cm, False, v_real)
                   if dtype == torch.bfloat16 else None)


def k4_seeds(dev, seeds, report):
    """K4's bfloat16 cases of phase 8 (DG-STGCN's blocks with Cm 64; g 32,
    g = Cm, and joints padded 25 -> 32) over ``seeds`` input draws on the
    card, each through ``compare_k4``.  Counts the cases with outputs
    outside the elementwise bound and the outputs that ``graph_flips``
    explains; fails if one is left unexplained."""
    from dsgcn_tpu_torch.ops.kernels.bd_agg import (
        bd_dyn_graph_agg_subset, reference_bd_dyn_graph_agg_subset)
    shapes = [(Cm, T) for (_, _, Cm, T), _ in distinct(DG_BLOCKS)
              if Cm >= 64]
    rows, failed = [], []
    for seed in range(1, seeds + 1):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for Cm, T in shapes:
            for g, Vp, v_real in ((32, V, -1), (None, V, -1), (32, 32, 25)):
                d = block_inputs(gen, dev, Cm, T, torch.bfloat16, Vp, v_real,
                                 N=N_BLOCK, K=DG_K)
                args = (d["pre2"], d["x1t"], d["x2"], d["A"], d["alpha"],
                        d["beta"])
                kw = dict(K=DG_K, Cm=Cm, g=g, v_real=v_real)
                row = dict(seed=seed, Cm=Cm, T=T, V=Vp, v_real=v_real, g=g)
                try:
                    compare_k4(bd_dyn_graph_agg_subset(*args, **kw),
                               reference_bd_dyn_graph_agg_subset(*args, **kw),
                               d, Cm, v_real, torch.bfloat16, row)
                except RuntimeError:
                    failed.append(row)
                rows.append(row)
                del d
    outside = [r for r in rows if r["outside_elementwise"]]
    flips = [f for r in outside for f in r.get("flips", [])]
    summary = dict(
        seeds=seeds, cases=len(rows), cases_outside=len(outside),
        outputs_outside=sum(r["outside_elementwise"] for r in rows),
        explained=sum(f["explained"] for f in flips),
        max_outside_a_case=max([r["outside_elementwise"] for r in rows],
                               default=0),
        max_abs_err=max(r["max_abs_err"] for r in rows),
        worst_err_over_limit=max([abs(f["err"]) / f["limit"]
                                  for f in flips], default=0.0),
        max_from_midpoint_f32_ulps=max(
            [f["from_midpoint_f32_ulps"] for f in flips], default=0.0),
        # what the flip leaves of the error, in bfloat16 ulps of the output
        max_residual_out_ulps=max(
            [abs(f["err"] - f["flip"]) / 2.0 ** (np.floor(np.log2(max(
                abs(f["want"]), 1e-30))) - 7) for f in flips], default=0.0),
        failed=failed)
    report["k4_seeds"] = dict(summary, outside=outside)
    print("K4 bfloat16 over input draws: " + json.dumps(summary), flush=True)
    check(not failed, f"K4: {len(failed)} cases not explained by graph "
          f"flips")


def block_weights(rng, dev, C, KC, Cout, down):
    """Folded 1x1 weights of one GCN block, (in, out) orientation."""
    f = lambda *s: (torch.randn(s, generator=rng, device=dev)  # noqa
                    / np.sqrt(s[0]))
    w = dict(w_pre=f(C, KC), b_pre=f(KC), w_post=f(KC, Cout), b_post=f(Cout),
             w_down=None, b_down=None)
    if down:
        w.update(w_down=f(C, Cout), b_down=f(Cout))
    return w


TF32_FLOP_PER_S = 495e12        # tensor cores, dense, H100 SXM data sheet
BF16_FLOP_PER_S = 989e12


def block_bound(N, T, C, KC, Cout, K, Cm, down, xbytes, edge=False,
                post=True):
    """Least time (ms) of K5 (post=False: pre 1x1 + aggregation, output
    (N, T, V, K*Cm)) or K6 (the whole block) and what bounds it, two ways.
    Both count x read and the output written once, weights and queries
    once.  ``bound_ms``: the 1x1 products, the aggregation and the graph
    build in float32 over the CUDA-core rate.  ``bound_tc_ms``: the
    products on tensor cores as the kernels run them (float32 operands
    3xTF32, three terms over the TF32 rate; bfloat16 K5 one term at the
    bf16 rate; bfloat16 K6 two terms where x is an operand, three for the
    post product), the aggregation and the graph on CUDA cores."""
    rows = N * T * V
    act = rows * (C + (Cout if post else KC)) * xbytes
    wts = C * KC * (4 if post else xbytes) + 4 * KC
    if post:
        wts += 4 * (KC * Cout + Cout + ((C * Cout + Cout) if down else 0))
    small = 4 * (2 * N * K * Cm * V + K * V * V + 2 * K)
    pre = 2 * rows * C * KC
    prod_post = 2 * rows * KC * Cout if post else 0
    prod_down = 2 * rows * C * Cout if post and down else 0
    other = 2 * rows * V * KC + N * K * 6 * Cm * V * V
    if edge:
        other += N * Cm * V * V * 2 * E + N * 2 * (2 * Cm * E * Cm * V)
    t_bytes = (act + wts + small) / HBM_BYTES_PER_S
    t_ops = (pre + prod_post + prod_down + other) / F32_FLOP_PER_S
    if xbytes == 4:
        t_tc = 3 * (pre + prod_post + prod_down) / TF32_FLOP_PER_S
    elif post:
        t_tc = (2 * (pre + prod_down) + 3 * prod_post) / TF32_FLOP_PER_S
    else:
        t_tc = pre / BF16_FLOP_PER_S
    t_tc += other / F32_FLOP_PER_S
    # the MMAs' work as the kernels issue it (each split term counted)
    terms = (3 * (pre + prod_post + prod_down) if xbytes == 4
             else 2 * (pre + prod_down) + 3 * prod_post if post else pre)
    return dict(mma_flop=terms,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_tc_ms=1e3 * max(t_bytes, t_tc),
                bound_tc_by="bytes" if t_bytes >= t_tc else "operations")


def new_sum():
    return dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                bound_by=set())


SUMMED = ("ms", "plain_ms", "bound_ms", "library_ms", "bound_tc_ms",
          "parent_ms", "mma_flop")


def add_to(acc, row, n):
    for k in SUMMED:
        if row.get(k) is not None:
            acc[k] = (acc.get(k) or 0.0) + n * row[k]
    acc["bound_by"].add(row["bound_by"])


def parent_wrappers(root):
    """K5's, K6's and K7's wrappers from another checkout of the port (e.g.
    a ``git archive`` of the parent commit unpacked into ``root``), built
    from that checkout's sources into its own build directory, to time
    them beside this checkout's in one call: (fused_dyn_graph_agg_eval,
    fused_dggcn_block_eval, fused_dgmstcn_eval)."""
    import importlib
    import importlib.util
    from concurrent.futures import ThreadPoolExecutor
    pkg = pathlib.Path(root).resolve() / "dsgcn_tpu_torch" / "ops" / "kernels"
    name = "parent_kernels"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    build = importlib.import_module(name + "._build")
    t0 = time.perf_counter()
    kernels = ("dyn_graph_eval", "dggcn_block", "ms_tcn")
    with ThreadPoolExecutor(len(kernels)) as ex:
        list(ex.map(build.compile_kernel, kernels))
    print(f"parent kernels from {root} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return (importlib.import_module(name + ".dyn_graph")
            .fused_dyn_graph_agg_eval,
            importlib.import_module(name + ".dggcn_block")
            .fused_dggcn_block_eval,
            importlib.import_module(name + ".ms_tcn").fused_dgmstcn_eval)


def sass_mma(names=("dyn_graph_eval", "dggcn_block", "ms_tcn")):
    """The tensor-core instructions in each built library's SASS
    (``cuobjdump -sass``), by opcode: K5's, K6's and K7's products must
    show them."""
    import re
    import shutil
    from dsgcn_tpu_torch.ops.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        ops = {}
        for op in re.findall(r"\b(HMMA\.[A-Z0-9.]+|HGMMA\.[A-Z0-9.]+)",
                             sass):
            ops[op] = ops.get(op, 0) + 1
        check(bool(ops), f"no tensor-core instruction in {name}'s SASS")
        print(f"sass {name}: {json.dumps(ops)}", flush=True)
        out[name] = ops
    return out


def dg_kernel_checks(dev, rng, report, parent=None, k56_only=False):
    """Phase 8: K4, K5 and K6 at DG-STGCN's serving shapes (N = 128), K6
    also at DS-GCN's with edge attention, K1 at DG-STGCN's 'auto' blocks,
    each in f32 and bf16 against its plain version; f32 times per forward
    at b64 x M2 x T100, K5 and K6 beside ``parent``'s (``parent_wrappers``)
    where given, timed in turns.  Then the GCN blocks per eval path, and K2
    (and K1) at DG-STGCN's training shapes.  ``k56_only``: K5, K6 and the
    block times alone."""
    from dsgcn_tpu_torch.ops.kernels.bd_agg import (
        bd_dyn_graph_agg_subset, reference_bd_dyn_graph_agg_subset)
    from dsgcn_tpu_torch.ops.kernels.dggcn_block import (
        block_plan, fused_dggcn_block_eval, reference_dggcn_block_eval)
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
        eval_plan, fused_dyn_graph_agg_eval, reference_dyn_graph_agg_eval)
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    names = ("bd_dyn_graph_agg_subset", "fused_dyn_graph_agg_eval",
             "fused_dggcn_block_eval", "fused_dyn_graph_agg")
    worst = dict.fromkeys(names, 0.0)
    per_forward = {n: new_sum() for n in names}
    rows = report["dg_kernel_checks"] = []

    def record(row, kern, plain, library=None, bound=None, nblocks=0,
               old=None):
        """Time a f32 case (ms, plain ms, library ms, bounds; with ``old``,
        the parent's kernel in turns: old, new, new, old) and add it to the
        kernel's per-forward sums."""
        if old is not None:
            t = [cold_ms(f, flush=flush) for f in (old, kern, kern, old)]
            row.update(ms=(t[1] + t[2]) / 2, parent_ms=(t[0] + t[3]) / 2,
                       ms_runs=t[1:3], parent_ms_runs=[t[0], t[3]],
                       same_bits_as_parent=bool(torch.equal(old(), kern())))
        else:
            row.update(ms=cold_ms(kern, flush=flush))
        row.update(plain_ms=cold_ms(plain, iters=3, flush=flush),
                   library_ms=(cold_ms(library, flush=flush)
                               if library is not None else None),
                   blocks_per_forward=nblocks)
        row.update(bound if isinstance(bound, dict)
                   else dict(bound_ms=bound[0], bound_by=bound[1]))
        with_ratios(row)
        if "bound_tc_ms" in row:
            row["ms_over_bound_tc"] = row["ms"] / row["bound_tc_ms"]
            # the TF32 work of the MMAs over the kernel's whole time
            row["mma_tflop_s"] = row["mma_flop"] / row["ms"] / 1e9
        if nblocks:
            add_to(per_forward[row["kernel"]], row, nblocks)

    def done(row):
        worst[row["kernel"]] = max(worst[row["kernel"]], row["max_abs_err"])
        rows.append(row)
        print("kernel", json.dumps(row), flush=True)

    # K4 where 'auto' takes it (mid 64), g = 32 (the path's) and g = Cm,
    # and with joints padded 25 -> 32
    for (C, Cout, Cm, T), nb in distinct(DG_BLOCKS):
        if Cm < 64 or k56_only:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            for g, Vp, v_real in ((32, V, -1), (None, V, -1), (32, 32, 25)):
                d = block_inputs(rng, dev, Cm, T, dtype, Vp, v_real,
                                 N=N_BLOCK, K=DG_K)
                args = (d["pre2"], d["x1t"], d["x2"], d["A"], d["alpha"],
                        d["beta"])
                kw = dict(K=DG_K, Cm=Cm, g=g, v_real=v_real)
                kern = lambda: bd_dyn_graph_agg_subset(*args, **kw)  # noqa
                plain = lambda: reference_bd_dyn_graph_agg_subset(  # noqa
                    *args, **kw)
                row = dict(kernel=names[0], Cm=Cm, T=T, N=N_BLOCK, V=Vp,
                           v_real=v_real, g=g, dtype=str(dtype).split(".")[-1])
                compare_k4(kern(), plain(), d, Cm, v_real, dtype, row)
                if dtype == torch.float32 and g == 32 and Vp == V:
                    library = kernel_calls(d, Cm, False)[
                        "bd_dyn_graph_agg"][2]
                    record(row, kern, plain, library,
                           bound(d, names[0], Cm, False), nb)
                done(row)
                if g == 32 and Vp == V:
                    # K1 at the same block, the alternative for 'auto'
                    k1, k1_plain, k1_lib = kernel_calls(d, Cm, False)[
                        names[3]]
                    r1 = dict(kernel=names[3], Cm=Cm, T=T, N=N_BLOCK, K=DG_K,
                              dtype=str(dtype).split(".")[-1],
                              at="k4_block")
                    compare(names[3], k1(), k1_plain(), dtype, r1,
                            graph_flips(d, Cm, False)
                            if dtype == torch.bfloat16 else None)
                    record(r1, k1, k1_plain, k1_lib,
                           bound(d, names[3], Cm, False))
                    r1["blocks_per_forward"] = nb
                    done(r1)
                del d

    # K1 at the blocks where 'auto' takes it (mid 16 and 32), timed in both
    # types; the f32 times make the per-forward sums
    for (C, Cout, Cm, T), nb in distinct(DG_BLOCKS):
        if Cm >= 64 or k56_only:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            d = block_inputs(rng, dev, Cm, T, dtype, N=N_BLOCK, K=DG_K)
            kern, plain, library = kernel_calls(d, Cm, False)[names[3]]
            row = dict(kernel=names[3], Cm=Cm, T=T, N=N_BLOCK, K=DG_K,
                       dtype=str(dtype).split(".")[-1], model="dgstgcn")
            compare(names[3], kern(), plain(), dtype, row)
            record(row, kern, plain, library, bound(d, names[3], Cm, False),
                   nb if dtype == torch.float32 else 0)
            row["blocks_per_forward"] = nb
            done(row)
            del d

    # K5 at every block with c >= 64 ('fusedpre'); w_pre in x's dtype
    for (C, Cout, Cm, T), nb in distinct(DG_BLOCKS):
        if C < 64:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            d = block_inputs(rng, dev, Cm, T, dtype, N=N_BLOCK, K=DG_K)
            w = block_weights(rng, dev, C, DG_K * Cm, Cout, False)
            x = torch.randn((N_BLOCK, T, V, C), generator=rng,
                            device=dev).to(dtype)
            args = (x, w["w_pre"].to(dtype), w["b_pre"], d["x1"], d["x2"],
                    d["A"], d["alpha"], d["beta"])
            kern = lambda: fused_dyn_graph_agg_eval(  # noqa
                *args, K=DG_K, Cm=Cm)
            plain = lambda: reference_dyn_graph_agg_eval(  # noqa
                *args, K=DG_K, Cm=Cm)
            old = (None if parent is None else
                   lambda: parent[0](*args, K=DG_K, Cm=Cm))  # noqa
            row = dict(kernel=names[1], C=C, Cm=Cm, T=T, N=N_BLOCK,
                       dtype=str(dtype).split(".")[-1],
                       plan=list(eval_plan(N_BLOCK, T, V, C, DG_K, Cm,
                                           x.element_size())))
            compare(names[1], kern(), plain(), dtype, row)
            if dtype == torch.float32:
                record(row, kern, plain, None, block_bound(
                    N_BLOCK, T, C, DG_K * Cm, Cout, DG_K, Cm, False, 4,
                    post=False), nb, old)
            done(row)
            del d, x

    # K6 at every DG-STGCN block (down path where channels change) and at
    # DS-GCN's with edge attention
    dsgcn_mega = new_sum()
    for blocks, Kb, edge in ((DG_BLOCKS, DG_K, False), (DS_BLOCKS, K, True)):
        for (C, Cout, Cm, T), nb in distinct(blocks):
            down = C != Cout
            for dtype in (torch.float32, torch.bfloat16):
                d = block_inputs(rng, dev, Cm, T, dtype, N=N_BLOCK, K=Kb)
                w = block_weights(rng, dev, C, Kb * Cm, Cout, down)
                x = torch.randn((N_BLOCK, T, V, C), generator=rng,
                                device=dev).to(dtype)
                args = (x, d["x1"], d["x2"], w["w_pre"], w["b_pre"], d["A"],
                        d["alpha"], d["beta"], w["w_post"], w["b_post"],
                        w["w_down"], w["b_down"])
                kw = dict(K=Kb, Cm=Cm)
                if edge:
                    kw.update(edge_w=d["ew"], edge_b=d["eb"],
                              edge_sel=d["sel"], edge_k=1, edge_num=E)
                kern = lambda: fused_dggcn_block_eval(*args, **kw)  # noqa
                plain = lambda: reference_dggcn_block_eval(  # noqa
                    *args, **kw)
                old = (None if parent is None else
                       lambda: parent[1](*args, **kw))  # noqa
                row = dict(kernel=names[2], C=C, Cout=Cout, Cm=Cm, K=Kb,
                           T=T, N=N_BLOCK, down=down, edge=edge,
                           dtype=str(dtype).split(".")[-1],
                           plan=list(block_plan(N_BLOCK, T, V, C, Kb, Cm,
                                                Cout, x.element_size(),
                                                down)))
                compare(names[2], kern(), plain(), dtype, row)
                if dtype == torch.float32:
                    record(row, kern, plain, None, block_bound(
                        N_BLOCK, T, C, Kb * Cm, Cout, Kb, Cm, down, 4,
                        edge), nb if not edge else 0, old)
                    if edge:
                        add_to(dsgcn_mega, row, nb)
                done(row)
                del d, x
    if parent is not None:
        report["k56_bits_differ_from_parent"] = [
            {k: r[k] for k in ("kernel", "C", "Cm", "T")} for r in rows
            if r.get("same_bits_as_parent") is False]
        print("K5/K6 shapes whose outputs differ from the parent's in any "
              "bit: " + json.dumps(report["k56_bits_differ_from_parent"]),
              flush=True)
        slower = [{k: r[k] for k in ("kernel", "C", "Cm", "T", "ms",
                                     "parent_ms")}
                  for r in rows if r.get("parent_ms") is not None
                  and r["ms"] > r["parent_ms"]]
        report["slower_than_parent"] = slower
        print("K5/K6 shapes slower than the parent's kernel: "
              + json.dumps(slower), flush=True)
    report["dg_per_forward"] = per_forward
    report["dsgcn_mega_per_forward"] = dsgcn_mega
    blocks = report["dg_block_ms"] = dg_block_times(dev, flush)
    ds_blocks = report["ds_block_ms"] = ds_block_times(dev, flush)
    # beside K5 and K6, the unfused blocks they replace ('fused': K1 between
    # cuBLAS 1x1s; K5 takes the blocks with C >= 64)
    per_forward[names[1]]["unfused_ms"] = blocks["fused_c64"]
    per_forward[names[2]]["unfused_ms"] = blocks["fused"]
    dsgcn_mega["unfused_ms"] = ds_blocks["auto"]
    for acc in (per_forward[names[1]], per_forward[names[2]], dsgcn_mega):
        acc["mma_tflop_s"] = acc.get("mma_flop", 0.0) / acc["ms"] / 1e9
    for k in (names[1], names[2]):
        print(f"{k} per forward: " + json.dumps(
            per_forward[k], default=sorted), flush=True)
    print("fused_dggcn_block_eval per DS-GCN forward: " + json.dumps(
        dsgcn_mega, default=sorted), flush=True)
    if k56_only:
        return worst, per_forward, None, None
    worst_t, per_step = dg_k2_checks(dev, rng, report, flush)
    return worst, per_forward, worst_t, per_step


def dg_block_times(dev, flush):
    """Device time of each DG-STGCN GCN block (the DGGCN module in eval,
    f32, N = 128) per eval path, summed per forward: 'fused' is the
    unfused block (pre 1x1 + BN + ReLU, K1, post 1x1 + BN, residual) that
    K5 ('fusedpre') and K6 ('mega') replace."""
    from dsgcn_tpu_torch.graph import Graph
    from dsgcn_tpu_torch.models.builder import init_weights_
    from dsgcn_tpu_torch.ops.gcn import DGGCN
    A = Graph(layout="nturgb+d", mode="random", num_filter=DG_K,
              seed=0).A.astype(np.float32)
    sums = {}
    gen = torch.Generator().manual_seed(9)
    for (C, Cout, Cm, T), nb in distinct(DG_BLOCKS):
        m = init_weights_(DGGCN(C, Cout, A_init=A, use_pallas=True), gen)
        nudge_gates_(m, gen)
        m = m.to(dev).eval()
        x = torch.randn(N_BLOCK, T, V, C, generator=gen).to(dev)
        for ek in ("fused", "fusedpre", "mega"):
            m.eval_kernel = ek
            with torch.inference_mode():
                ms = cold_ms(lambda: m(x), flush=flush)
            sums[ek] = sums.get(ek, 0.0) + nb * ms
            if C >= 64:
                sums[ek + "_c64"] = sums.get(ek + "_c64", 0.0) + nb * ms
            print(f"DGGCN block C={C} Cout={Cout} mid={Cm} T={T} "
                  f"{ek}: {ms:.3f} ms (x{nb} per forward)", flush=True)
        del m, x
    print("DGGCN blocks per forward, ms: " + json.dumps(sums), flush=True)
    return sums


def ds_block_times(dev, flush):
    """Device time of DS-GCN's ten GCN blocks (DGPHGCN1 in eval, f32, the
    j config at b64 x M2 x T100, each on the input a forward gives it) per
    eval path, summed per forward: 'auto' (K3 between cuBLAS 1x1s) is the
    unfused block that 'mega' (K6) replaces."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    from dsgcn_tpu_torch.ops.gcn import DGPHGCN1
    gen = torch.Generator().manual_seed(10)
    model = init_weights_(build_model(Config.fromfile(str(CONFIG))["model"]),
                          gen)
    nudge_gates_(model, gen)
    model = model.to(dev).eval()
    blocks = [m for m in model.modules() if isinstance(m, DGPHGCN1)]
    check(len(blocks) == 10, f"DS-GCN has {len(blocks)} DGPHGCN1 blocks")
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.setdefault(id(mod), args[0]))
        for m in blocks]
    with torch.inference_mode():
        model(torch.randn(*THROUGHPUT_BATCH, generator=gen).to(dev))
    for h in hooks:
        h.remove()
    sums = {}
    for i, m in enumerate(blocks):
        x = inputs[id(m)]
        for ek in ("auto", "mega"):
            m.eval_kernel = ek
            with torch.inference_mode():
                ms = cold_ms(lambda: m(x), flush=flush)
            sums[ek] = sums.get(ek, 0.0) + ms
            print(f"DGPHGCN1 block {i} {tuple(x.shape)} -> "
                  f"{m.out_channels} {ek}: {ms:.3f} ms", flush=True)
    del inputs, model
    print("DGPHGCN1 blocks per forward, ms: " + json.dumps(sums), flush=True)
    return sums


def dg_k2_checks(dev, rng, report, flush):
    """K2 (and K1) at DG-STGCN's training shapes (K = 8, no edge
    attention, N = 256), f32 and bf16, against the plain backward; at one
    Cm = 64 shape also against autograd through the plain forward."""
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
        fused_dyn_graph_agg_bwd, reference_dyn_graph_agg,
        reference_dyn_graph_agg_bwd)
    worst = {"fused_dyn_graph_agg": 0.0, "fused_dyn_graph_agg_bwd": 0.0}
    per_step = {name: new_sum() for name in worst}
    for Cm, T, nblocks in DG_TRAIN_BLOCK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            d = block_inputs(rng, dev, Cm, T, dtype, N=N_TRAIN, K=DG_K)
            d["dy"] = torch.randn(d["pre"].shape, generator=rng,
                                  device=dev).to(dtype)
            args = k2_args(d, Cm, False)
            got = fused_dyn_graph_agg_bwd(*args)
            refs = {"plain": reference_dyn_graph_agg_bwd(*args)}
            if dtype == torch.float32 and (Cm, T) == (64, 15):
                ins = [a.detach().requires_grad_() for a in args[:6]]
                with torch.enable_grad():
                    y = reference_dyn_graph_agg(*ins, K=DG_K, Cm=Cm)
                    refs["autograd"] = list(torch.autograd.grad(
                        y, ins, d["dy"])) + [None, None]
            row = dict(kernel="fused_dyn_graph_agg_bwd", Cm=Cm, T=T,
                       N=N_TRAIN, K=DG_K, dtype=str(dtype).split(".")[-1], edge=False)
            compare_k2(got, refs, dtype, row)
            rows = [row]
            if dtype == torch.float32:
                row.update(k2_times(d, args, Cm, flush))
                with_ratios(row)
            rows.append(k1_at_training_shape(d, Cm, dtype, flush,
                                             edge=False))
            for r in rows:
                worst[r["kernel"]] = max(worst[r["kernel"]],
                                         r["max_abs_err"])
                r["blocks_per_step"] = nblocks
                if dtype == torch.float32:
                    add_to(per_step[r["kernel"]], r, nblocks)
                report["dg_k2_checks"].append(r)
                print("kernel", json.dumps(r), flush=True)
            del d, got, refs
    report["dg_per_step"] = per_step
    return worst, per_step


# ---------------------------------------------------------------------------
# --sweep: K1 and K3 under every block plan near the planner's
# ---------------------------------------------------------------------------

def plan_sweep(dev):
    """K1 and K3 at each of their main-path shapes (K3 in DS-GCN serving,
    K1 in DS-GCN and DG-STGCN training and DG-STGCN's 'auto' forward, with
    the paths' edge attention), f32 and bf16, timed under the planner's
    block plan and every plan of CG channels (16-byte runs) and 1-8 row
    blocks.  The planned plan's time over the best one is the planner's
    regret; the sweep calibrates its constants (``dyn_graph._BUILD_ROWS``,
    ``_SETUP_ROWS``, ``_HIDE_WARPS``)."""
    from dsgcn_tpu_torch.ops.kernels import _build, bd_agg, dyn_graph
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    shapes = (
        [("bd_dyn_graph_agg", N_BLOCK, K, Cm, T, True)
         for Cm, T, _ in BLOCK_SHAPES]
        + [("fused_dyn_graph_agg", N_TRAIN, K, Cm, T, True)
           for Cm, T, _ in TRAIN_BLOCK_SHAPES]
        + [("fused_dyn_graph_agg", N_BLOCK, DG_K, Cm, T, False)
           for (_, _, Cm, T), _ in distinct(DG_BLOCKS) if Cm < 64]
        + [("fused_dyn_graph_agg", N_TRAIN, DG_K, Cm, T, False)
           for Cm, T, _ in DG_TRAIN_BLOCK_SHAPES])
    planner, rows = dyn_graph.agg_plan, []
    try:
        for name, N, Kk, Cm, T, edge in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                d = block_inputs(rng, dev, Cm, T, dtype, N=N, K=Kk)
                kern = kernel_calls(d, Cm, edge)[name][0]
                esize = d["pre"].element_size()
                planned = planner(N, T, V, Kk, Cm, esize)
                plans = {planned}
                for CG in range(1, min(Cm, 32) + 1):
                    if Cm % CG or (CG * esize) % 16 or dyn_graph.agg_block(
                            V, Cm, CG, esize)[0] > _build.AGG_MAX_THREADS:
                        continue
                    plans.update((CG, -(-T // S)) for S in (1, 2, 3, 4, 6, 8))
                times = {}
                for plan in sorted(plans):
                    dyn_graph.agg_plan = bd_agg.agg_plan = (
                        lambda *_, plan=plan: plan)
                    times[plan] = cold_ms(kern, flush=flush)
                dyn_graph.agg_plan = bd_agg.agg_plan = planner
                best = min(times, key=times.get)
                row = dict(kernel=name, N=N, K=Kk, Cm=Cm, T=T, edge=edge,
                           dtype=str(dtype).split(".")[-1],
                           plan=list(planned), ms=times[planned],
                           best=list(best), best_ms=times[best],
                           plan_over_best=times[planned] / times[best],
                           sweep={f"{cg}x{r}": ms
                                  for (cg, r), ms in times.items()})
                rows.append(row)
                print("sweep", json.dumps(row), flush=True)
                del d
    finally:
        dyn_graph.agg_plan = bd_agg.agg_plan = planner
    return rows


def block_sweep(dev):
    """K6 at each DG-STGCN and DS-GCN serving block shape (N = 128, the
    edge subset on DS-GCN's) and K5 at DG-STGCN's, f32, timed under the
    planner's plan and every plan (frames a tile, chunk of 8 channels or
    more) that fits a block.  The planned plan's time over the best one is
    the planner's regret; the sweep calibrates its cost model
    (``_build.MMA_FLOP_CLK``, ``ENTRY_INSTR``, ``PANEL_CLK``,
    ``CHUNK_CLK``)."""
    from dsgcn_tpu_torch.ops.kernels import _build
    from dsgcn_tpu_torch.ops.kernels import dggcn_block as db
    from dsgcn_tpu_torch.ops.kernels import dyn_graph as dg
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    shapes = ([(C, Cout, DG_K, Cm, T, False)
               for (C, Cout, Cm, T), _ in distinct(DG_BLOCKS)]
              + [(C, Cout, K, Cm, T, True)
                 for (C, Cout, Cm, T), _ in distinct(DS_BLOCKS)])
    planners, rows = (db.block_plan, dg.eval_plan), []

    def sweep(kernel, shape, planned, smem_of, call, patch):
        times = {}
        for R, TT in dg._row_tiles(shape["T"], V):
            for CH in dg.pw_chunks(shape["K"], shape["Cm"]):
                smem = smem_of(R, CH)
                if CH < 8 or smem == 0 or smem > _build.BLOCK_SMEM:
                    continue
                patch((TT, R, CH))
                times[(TT, R, CH)] = cold_ms(call, iters=5, flush=flush)
        best = min(times, key=times.get)
        row = dict(kernel=kernel, **shape, plan=list(planned),
                   ms=times[planned], best=list(best), best_ms=times[best],
                   plan_over_best=times[planned] / times[best],
                   sweep={"x".join(map(str, p)): ms
                          for p, ms in times.items()})
        rows.append(row)
        print("sweep", json.dumps(row), flush=True)

    try:
        for C, Cout, Kk, Cm, T, edge in shapes:
            down = C != Cout
            d = block_inputs(rng, dev, Cm, T, torch.float32, N=N_BLOCK, K=Kk)
            w = block_weights(rng, dev, C, Kk * Cm, Cout, down)
            x = torch.randn((N_BLOCK, T, V, C), generator=rng, device=dev)
            args = (x, d["x1"], d["x2"], w["w_pre"], w["b_pre"], d["A"],
                    d["alpha"], d["beta"], w["w_post"], w["b_post"],
                    w["w_down"], w["b_down"])
            kw = dict(K=Kk, Cm=Cm)
            if edge:
                kw.update(edge_w=d["ew"], edge_b=d["eb"], edge_sel=d["sel"],
                          edge_k=1, edge_num=E)
            shape = dict(C=C, Cout=Cout, K=Kk, Cm=Cm, T=T, edge=edge)
            planned = planners[0](N_BLOCK, T, V, C, Kk, Cm, Cout, 4, down)

            def patch6(p):
                db.block_plan = lambda *_, p=p: p + (0.0,)
            sweep("fused_dggcn_block_eval", shape, tuple(planned[:3]),
                  lambda R, CH: db.block_smem(V, C, Kk, Cm, Cout, 4, R, CH),
                  lambda: db.fused_dggcn_block_eval(*args, **kw), patch6)
            db.block_plan = planners[0]
            if not edge:
                a5 = (x, w["w_pre"], w["b_pre"], d["x1"], d["x2"], d["A"],
                      d["alpha"], d["beta"])

                def patch5(p):
                    dg.eval_plan = lambda *_, p=p: p
                sweep("fused_dyn_graph_agg_eval", shape,
                      planners[1](N_BLOCK, T, V, C, Kk, Cm, 4),
                      lambda R, CH: dg.eval_block(V, C, Kk, Cm, 4, R, CH),
                      lambda: dg.fused_dyn_graph_agg_eval(*a5, K=Kk, Cm=Cm),
                      patch5)
                dg.eval_plan = planners[1]
            del d, x
    finally:
        db.block_plan, dg.eval_plan = planners
    return rows


# ---------------------------------------------------------------------------
# phase 9: DG-STGCN serving through the entry points
# ---------------------------------------------------------------------------

# launches per forward of DG-STGCN's eval paths
DG_AUTO = {"fused_dyn_graph_agg": 7, "bd_dyn_graph_agg_subset": 3}
DG_OPTIONS = {
    "bd": {"bd_dyn_graph_agg": 10},
    "bdps": {"bd_dyn_graph_agg_subset": 10},
    "bdg": {"bd_dyn_graph_agg_subset": 10},
    "fused": {"fused_dyn_graph_agg": 10},
    "fusedpre": {"fused_dyn_graph_agg_eval": 9, "fused_dyn_graph_agg": 1},
    "mega": {"fused_dggcn_block_eval": 10},
}


def expect_counts(counts, per_forward, forwards, what):
    """Every kernel launched exactly as often as the path says."""
    want = dict.fromkeys(counts, 0)
    want.update({k: n * forwards for k, n in per_forward.items()})
    check(counts == want, f"{what} launched {counts}, expected {want}")


def dg_config(eval_kernel=None):
    """The DS-GCN j config with its model replaced by DG-STGCN."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.models.builder import model_cfg
    cfg = Config.fromfile(str(CONFIG))
    cfg["model"] = model_cfg("dgstgcn")
    if eval_kernel is not None:
        cfg["model"]["backbone"]["gcn_eval_kernel"] = eval_kernel
    return cfg


def build_dgstgcn():
    from dsgcn_tpu_torch.models.builder import build_model
    return build_model(dg_config()["model"])


def serve_dgstgcn(dev, card, report):
    """Phase 9.  Returns the launch counts of 'auto' (the main path) and of
    each eval_kernel option, over the four requests."""
    from dsgcn_tpu_torch.apis import (inference_recognizer, init_recognizer,
                                      to_bf16_inference)
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.ops.gcn import DGGCN

    out = report["dgstgcn_serving"] = dict(requests=[], options={})
    torch.manual_seed(1)
    model = init_recognizer(dg_config(), device=dev)
    pipeline = build_pipeline(model.cfg["data"]["test"]["pipeline"])
    calibrate_(model, torch.from_numpy(pipeline(
        synthetic_annos(seed=1)[0])["keypoint"]).to(dev), seed=3)
    annos = synthetic_annos(seed=2)
    blocks = [getattr(model.backbone, f"block{i}").gcn
              for i in range(model.backbone.num_blocks)]
    check(len(blocks) == 10 and all(isinstance(b, DGGCN) for b in blocks),
          "DG-STGCN has not ten DGGCN blocks")

    # the main path ('auto'), counts read around it
    reset_counts()
    answers, request_ms = [], []
    for a in annos:
        t0 = time.perf_counter()
        answers.append(inference_recognizer(model, a))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    auto_counts = read_counts()
    print("DG-STGCN main path launches", json.dumps(auto_counts), flush=True)
    print("DG-STGCN request latency ms (f32): "
          + ", ".join(f"{ms:.3f}" for ms in request_ms), flush=True)
    expect_counts(auto_counts, DG_AUTO, len(annos), "DG-STGCN 'auto'")
    out["request_ms"] = {"f32": request_ms}

    cpu = init_recognizer(dg_config(), device="cpu")
    cpu.load_state_dict(model.state_dict(), strict=True)
    auto_logits = []
    for a, ans in zip(annos, answers):
        cpu_ans = inference_recognizer(cpu, a)
        g, c = logits_of(model, pipeline, a), logits_of(cpu, pipeline, a)
        check(g.shape == (10, 60) and bool(torch.isfinite(g).all()),
              f"logits of shape {tuple(g.shape)} or not finite")
        err = rel_err(g, c)
        print(f"DG-STGCN request {a['frame_dir']}: gpu top-5 {ans}; cpu "
              f"top-5 {cpu_ans}; logits rel err {err:.3e} (max |logit| "
              f"{c.abs().max().item():.3f})", flush=True)
        check(ans[0][0] == cpu_ans[0][0],
              f"DG-STGCN GPU top-1 {ans[0]} != CPU top-1 {cpu_ans[0]}")
        check(err <= 1e-3, f"DG-STGCN GPU logits off the CPU's by {err:.3e}")
        out["requests"].append(dict(request=a["frame_dir"], top5=ans,
                                    cpu_top5=cpu_ans, logits_rel_err=err))
        auto_logits.append(g)
    del cpu

    # every eval_kernel option on the same weights
    option_counts = {}
    for ek, per_forward in DG_OPTIONS.items():
        m = init_recognizer(dg_config(ek), device=dev)
        m.load_state_dict(model.state_dict(), strict=True)
        reset_counts()
        logits = [logits_of(m, pipeline, a) for a in annos]
        torch.cuda.synchronize()
        counts = option_counts[ek] = read_counts()
        errs = [rel_err(lg, al) for lg, al in zip(logits, auto_logits)]
        print(f"DG-STGCN {ek}: launches {json.dumps(counts)}; logits vs "
              "auto rel err " + ", ".join(f"{e:.3e}" for e in errs),
              flush=True)
        expect_counts(counts, per_forward, len(annos), f"DG-STGCN {ek!r}")
        check(max(errs) <= 1e-4,
              f"DG-STGCN {ek!r} logits off 'auto' by {max(errs):.3e}")
        out["options"][ek] = dict(counts=counts, logits_rel_err=errs)
        del m

    bf16 = to_bf16_inference(model)
    out["request_ms"]["bf16"] = []
    out["bf16_top1_equal"] = []
    for a, ans in zip(annos, answers):
        t0 = time.perf_counter()
        bans = inference_recognizer(bf16, a)
        out["request_ms"]["bf16"].append((time.perf_counter() - t0) * 1e3)
        out["bf16_top1_equal"].append(bans[0][0] == ans[0][0])
        print(f"DG-STGCN request {a['frame_dir']}: bf16 top-5 {bans}",
              flush=True)
    throughput(model, bf16, dev, card, out)
    return auto_counts, option_counts


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
    from dsgcn_tpu_torch.ops.kernels import wrappers
    for w in wrappers():
        w.launches = 0


def read_counts():
    from dsgcn_tpu_torch.ops.kernels import launch_counts
    return launch_counts()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float().cpu() - b.float().cpu()).abs().max()
            / b.float().abs().max()).item()


def logits_of(model, pipeline, anno):
    # a deep copy: PreNormalize2D normalizes the anno's keypoints in place
    kp = torch.from_numpy(pipeline(copy.deepcopy(anno))["keypoint"])
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

    # 'mega' (K6): the whole GCN block in one kernel, same weights
    cfg = Config.fromfile(str(CONFIG))
    cfg["model"]["backbone"]["gcn_eval_kernel"] = "mega"
    mega = init_recognizer(cfg, device=dev)
    mega.load_state_dict(model.state_dict(), strict=True)
    reset_counts()
    mega_logits = [logits_of(mega, pipeline, a) for a in annos]
    torch.cuda.synchronize()
    mega_counts = read_counts()
    print("DS-GCN mega path launches", json.dumps(mega_counts), flush=True)
    expect_counts(mega_counts, {"fused_dggcn_block_eval": nblocks},
                  len(annos), "DS-GCN 'mega'")
    errs = [rel_err(m, logits_of(model, pipeline, a))
            for m, a in zip(mega_logits, annos)]
    print("DS-GCN mega vs bd logits rel err "
          + ", ".join(f"{e:.3e}" for e in errs), flush=True)
    check(max(errs) <= 1e-4, f"DS-GCN mega logits off bd by {max(errs)}")
    report["dsgcn_mega"] = dict(counts=mega_counts, logits_rel_err=errs)
    del mega, fused

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


def throughput(model, bf16, dev, card, out, tag="", shape=THROUGHPUT_BATCH,
               classes=60):
    """Phases 5 (DS-GCN), 9 (DG-STGCN), 12 (STGCN++), 13 (K7 in DG-STGCN
    and DS-GCN) and 15 (DS-GCN on COCO): clips/s of a batch forward of
    ``shape`` in f32 and bf16, each with a profiler breakdown; into
    ``out``."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        shape).astype(np.float32)).to(dev)
    for name, m in (("f32", model), ("bf16", bf16)):
        with torch.inference_mode():
            for _ in range(2):
                y = m(x)
            torch.cuda.synchronize()
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                y = m(x)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
        n = shape[0]
        check(y.shape == (n, classes) and bool(torch.isfinite(y).all()),
              f"{name} batch forward gave {tuple(y.shape)} / non-finite")
        clips = n / dt
        print(f"throughput {tag}{name}: batch {shape} "
              f"{dt * 1e3:.3f} ms/forward, {clips:.1f} clips/s on {card}",
              flush=True)
        out.setdefault("throughput", {})[name] = dict(
            ms_per_forward=dt * 1e3, clips_per_s=clips)
        breakdown(m, x, name, out, tag)


def breakdown(model, x, name, out, tag=""):
    """Device time of one batch forward by kernel (torch.profiler), the
    port's kernels' share, and the device's idle share of the forward's
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    out.setdefault("profile", {})[name] = device_rows(
        prof, wall_ms, f"profile {tag}{name}")


# the port's kernels, as the profiler names them
PORT_KERNELS = ("bd_agg_kernel", "dyn_graph_fwd_kernel", "edge_proj_kernel",
                "edge_ctr_kernel", "bwd_ada_kernel", "bwd_contract_kernel",
                "edge_dp_sum_kernel", "edge_dx_kernel", "bwd_finish_kernel",
                "edge_dw_kernel", "sum_over_samples_kernel",
                "dyn_graph_eval_kernel", "dggcn_block_kernel",
                "ms_tcn_kernel")


def device_rows(prof, wall_ms, tag):
    """Device time by kernel from a profile, the port's kernels' share and
    the device's idle share of ``wall_ms``; printed and returned."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type.name == "CUDA":
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"{tag}: the profiler saw no device time", flush=True)
        return {}
    ours = sum(r[0] for r in rows if any(k in r[2] for k in PORT_KERNELS))
    launches = sum(r[1] for r in rows)
    print(f"{tag}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"wall (idle {1 - busy / wall_ms:.1%}, under the profiler) in "
          f"{launches} kernel launches; the port's kernels {ours:.3f} ms "
          f"({ours / busy:.1%})", flush=True)
    for ms, count, key in rows[:12]:
        print(f"{tag}: {ms:9.3f} ms {count:4d}x {key[:90]}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy, port_kernels_ms=ours,
                launches=launches,
                top=[dict(ms=ms, count=c, kernel=k) for ms, c, k in rows[:25]])


# ---------------------------------------------------------------------------
# phase 11: K7 against its plain version
# ---------------------------------------------------------------------------

STGCNPP_CONFIG = ROOT / "configs" / "stgcnpp" / "ntu60_xsub_3dkp" / "j.py"
# STGCN++ (MSTCN) and DG-STGCN / DS-GCN (DGMSTCN, with the pseudo-joint)
# at b64 x M2 x T100 (N = 128 skeletons): (C, T in, stride, blocks) of
# their ten temporal units
TCN_SHAPES = [(64, 100, 1, 4), (128, 100, 2, 1), (128, 50, 1, 2),
              (256, 50, 2, 1), (256, 25, 1, 2)]
# of the largest output: float32, the same sums in another order; bfloat16,
# the output is rounded once on both sides and may round the other way
K7_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def k7_inputs(gen, dev, C, T, dtype, coeff, Vx=V, N=N_BLOCK):
    """x (N, T, Vx, C) and random folded weights of a C -> C region (mid
    C // 6), as fused_dgmstcn_eval takes them."""
    mid = C // 6
    rem = C - 5 * mid
    P = rem + 4 * mid

    def w(*s):
        return (torch.randn(*s, generator=gen) / s[-2] ** 0.5).to(dev)

    def b(n):
        return (0.1 * torch.randn(n, generator=gen)).to(dev)

    def a(n):
        return (0.5 + torch.rand(n, generator=gen)).to(dev)
    widths = (rem, mid, mid, mid)
    x = torch.randn(N, T, Vx, C, generator=gen).to(dev, dtype)
    return [x, w(C, P), b(P), [w(3, cb, cb) for cb in widths],
            [b(cb) for cb in widths], w(C, mid), b(mid), a(C), b(C),
            w(C, C), b(C), a(C), b(C),
            (torch.rand(Vx, generator=gen) - 0.5).to(dev) if coeff else None]


def k7_bound(args, stride):
    """Least time (ms) of K7's work and what bounds it, two ways.  Both
    count x read and the output written once, the weights once.
    ``bound_ms``: the region's float32 operations (pre 1x1, taps, maxpool,
    strided 1x1, pseudo-joint mean and broadcast, the BN affines and
    ReLUs, the transform 1x1) over the CUDA-core rate.  ``bound_tc_ms``:
    the products (pre, taps, strided and transform 1x1s) on tensor cores
    as the kernel runs them (float32 operands 3xTF32, three terms over the
    TF32 rate; a bfloat16 x two terms in the pre and strided 1x1), the
    rest on CUDA cores, as ``block_bound`` counts K5's and K6's."""
    x, w11, coeff = args[0], args[5], args[-1]
    N, T, Vx, C = x.shape
    rem, mid = args[3][0].shape[-1], w11.shape[-1]
    P, Cp = rem + 4 * mid, rem + 5 * mid
    Tp, R = -(-T // stride), Vx + (coeff is not None)
    weights = sum(t.numel() for t in args[1:-1] if torch.is_tensor(t))
    weights += sum(t.numel() for t in args[3] + args[4])
    weights += 0 if coeff is None else coeff.numel()
    nbytes = (N * T * Vx * C + N * Tp * Vx * Cp) * x.element_size() \
        + 4 * weights
    rows_in, rows_out = N * T * R, N * Tp * R
    prod_x = rows_in * 2 * C * P + rows_out * 2 * C * mid     # pre, 1x1
    prod_f = (rows_out * 6 * (rem * rem + 3 * mid * mid)      # taps
              + N * Tp * Vx * 2 * Cp * Cp)                    # transform
    other = (rows_in * 2 * P                                  # pre bias
             + rows_out * (rem + 3 * mid + 2 * mid + mid)     # bias, max
             + N * Tp * Vx * 8 * Cp)                          # affines
    if coeff is not None:
        other += N * T * Vx * C                               # mean
    terms_x = 3 if x.element_size() == 4 else 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (prod_x + prod_f + other) / F32_FLOP_PER_S
    mma = terms_x * prod_x + 3 * prod_f
    t_tc = mma / TF32_FLOP_PER_S + other / F32_FLOP_PER_S
    return dict(mma_flop=mma,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_tc_ms=1e3 * max(t_bytes, t_tc),
                bound_tc_by="bytes" if t_bytes >= t_tc else "operations")


def k7_plans(C, T, stride, xsize, coeff, Vx=V, N=N_BLOCK):
    """The planner's (TO, JR) for K7's blocks at a TCN_SHAPES shape, and
    the pseudo-joint blocks' TO with ``coeff``."""
    from dsgcn_tpu_torch.ops.kernels.ms_tcn import tile_plan
    mid = C // 6
    shape = (N, T, Vx, C, C - 5 * mid, mid, stride, 4)
    plan = list(tile_plan(*shape, xsize))
    return plan + ([tile_plan(*shape, 4, mean=True)[0]] if coeff else [])


def k7_case(dev, gen, flush, C, T, stride, coeff, dtype, Vx=V, N=N_BLOCK,
            parent=None):
    """K7 at one shape against its plain version (``K7_TOL``); in f32 also
    its time, the plain version's, both bounds (``k7_bound``), the MMAs'
    rate and the unfused region's (the MSTCN / DGMSTCN module in eval
    without K7: cuBLAS 1x1s, cuDNN convs), and ``parent``'s K7 timed in
    turns where given.  Returns the row (printed)."""
    from dsgcn_tpu_torch.ops.kernels.ms_tcn import (
        fused_dgmstcn_eval, reference_fused_dgmstcn_eval)
    from dsgcn_tpu_torch.ops.tcn import DGMSTCN, MSTCN
    args = k7_inputs(gen, dev, C, T, dtype, coeff, Vx, N)
    kern = lambda: fused_dgmstcn_eval(*args, stride=stride)  # noqa: E731
    plain = lambda: reference_fused_dgmstcn_eval(  # noqa: E731
        *args, stride=stride)
    row = dict(kernel="fused_dgmstcn_eval", V=Vx, C=C, T=T, stride=stride,
               N=N, coeff=coeff, dtype=str(dtype).split(".")[-1],
               plan=k7_plans(C, T, stride, args[0].element_size(), coeff, Vx,
                             N))
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    row.update(max_abs_err=err, max_abs_ref=ref, rel_err=err / ref,
               tol=K7_TOL[dtype])
    check(bool(torch.isfinite(got.float()).all()),
          f"K7 non-finite output at {row}")
    check(got.dtype == dtype and got.shape == want.shape,
          f"K7 returned {got.dtype} {tuple(got.shape)}")
    check(err <= K7_TOL[dtype] * ref,
          f"K7 disagrees with its plain version: {row}")
    del got, want
    if dtype == torch.float32:
        module = (DGMSTCN(C, C, stride=stride, num_joints=Vx) if coeff
                  else MSTCN(C, C, stride=stride)).to(dev).eval()
        with torch.inference_mode():
            unfused = cold_ms(lambda: module(args[0]), flush=flush)
        if parent is not None:
            old = lambda: parent[2](*args, stride=stride)  # noqa: E731
            t = [cold_ms(f, flush=flush) for f in (old, kern, kern, old)]
            row.update(ms=(t[1] + t[2]) / 2, parent_ms=(t[0] + t[3]) / 2,
                       ms_runs=t[1:3], parent_ms_runs=[t[0], t[3]])
        else:
            row.update(ms=cold_ms(kern, flush=flush))
        row.update(plain_ms=cold_ms(plain, iters=3, flush=flush),
                   unfused_ms=unfused, library_ms=None,
                   **k7_bound(args, stride))
        row.update(ms_over_bound_tc=row["ms"] / row["bound_tc_ms"],
                   mma_tflop_s=row["mma_flop"] / row["ms"] / 1e9)
        del module
    print("kernel", json.dumps(row), flush=True)
    return row


def k7_path_checks(dev, report, key, shapes, Vx, N, coeff, parent=None):
    """K7 at the temporal unit ``shapes`` (C, T, stride, blocks) of one
    path, joint count ``Vx`` and ``N`` skeletons, f32 and bf16 against its
    plain version (``k7_case``); f32 times (and ``parent``'s) summed per
    forward.  Returns the worst max abs error and the sums."""
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    gen = torch.Generator().manual_seed(17 + Vx)
    rows = report.setdefault("k7_checks", [])
    worst, acc = 0.0, dict(new_sum(), unfused_ms=0.0)
    for C, T, stride, nb in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            row = k7_case(dev, gen, flush, C, T, stride, coeff, dtype, Vx, N,
                          parent)
            worst = max(worst, row["max_abs_err"])
            if dtype == torch.float32 and nb:
                row["blocks_per_forward"] = nb
                add_to(acc, row, nb)
                acc["unfused_ms"] += nb * row["unfused_ms"]
            rows.append(dict(row, path=key))
    print(f"K7 per {key} forward (V = {Vx}, N = {N}), ms: "
          + json.dumps(acc, default=sorted), flush=True)
    report[f"k7_per_forward_{key}"] = acc
    return worst, acc


def k7_checks(dev, report, parent=None):
    """Phase 11: K7 at every temporal unit shape of STGCN++ serving (no
    pseudo-joint) and of DG-STGCN / DS-GCN serving (with it), stride 1 and
    2, f32 and bf16, against its plain version (``k7_path_checks``, which
    times the f32 cases beside the unfused region), and ``parent``'s K7
    (``parent_wrappers``) timed in turns where given, summed per forward
    at b64 x M2 x T100.  Returns the worst max abs error and the sums per
    forward by model."""
    worst, per_forward = 0.0, {}
    for key, coeff in (("stgcnpp", False), ("dgstgcn", True)):
        err, per_forward[key] = k7_path_checks(
            dev, report, key, TCN_SHAPES, V, N_BLOCK, coeff, parent)
        worst = max(worst, err)
        per_forward[key]["mma_tflop_s"] = (per_forward[key]["mma_flop"]
                                           / per_forward[key]["ms"] / 1e9)
    if parent is not None:
        slower = [{k: r[k] for k in ("C", "T", "stride", "coeff", "ms",
                                     "parent_ms")}
                  for r in report["k7_checks"]
                  if r.get("parent_ms") is not None
                  and r["ms"] > r["parent_ms"]]
        report["k7_slower_than_parent"] = slower
        print("K7 shapes slower than the parent's kernel: "
              + json.dumps(slower), flush=True)
    report["k7_per_forward"] = per_forward
    return worst, per_forward


def k7_sweep(dev):
    """K7 at each TCN_SHAPES shape, with and without the pseudo-joint, f32,
    timed under the planner's plan and the plans next to it: the eight
    that its cost model ranks cheapest after it (``ms_tcn.tile_plans``).
    The planned plan's time over the best one is the planner's regret."""
    from dsgcn_tpu_torch.ops.kernels import ms_tcn as mt
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    gen = torch.Generator().manual_seed(12)
    planner, rows = mt.tile_plan, []
    try:
        for C, T, stride, _ in TCN_SHAPES:
            mid = C // 6
            rem = C - 5 * mid
            plans = mt.tile_plans(N_BLOCK, T, V, C, rem, mid, stride, 4, 4)[:9]
            planned = plans[0]
            for coeff in (False, True):
                args = k7_inputs(gen, dev, C, T, torch.float32, coeff)
                times = {}
                for plan in plans:
                    mt.tile_plan = (lambda *a, plan=plan, **k:
                                    planner(*a, **k) if k.get("mean")
                                    else plan)
                    times[plan] = cold_ms(lambda: mt.fused_dgmstcn_eval(
                        *args, stride=stride), iters=5, flush=flush)
                mt.tile_plan = planner
                best = min(times, key=times.get)
                row = dict(kernel="fused_dgmstcn_eval", C=C, T=T,
                           stride=stride, coeff=coeff, plan=list(planned),
                           ms=times[planned], best=list(best),
                           best_ms=times[best],
                           plan_over_best=times[planned] / times[best],
                           sweep={"x".join(map(str, p)): ms
                                  for p, ms in times.items()})
                rows.append(row)
                print("sweep", json.dumps(row), flush=True)
                del args
    finally:
        mt.tile_plan = planner
    return rows


# ---------------------------------------------------------------------------
# phases 12-13: serving with K7
# ---------------------------------------------------------------------------

def with_k7(cfg, k7):
    cfg["model"]["backbone"]["tcn_use_pallas"] = k7
    return cfg


def stgcnpp_config(k7):
    """The STGCN++ j config, its temporal units in K7 or not."""
    from dsgcn_tpu_torch.configs.config import Config
    return with_k7(Config.fromfile(str(STGCNPP_CONFIG)), k7)


def k7_model_pair(dev, cfg_of, seed, calib=None):
    """The model of ``cfg_of(False)`` (module-path temporal units, so that
    every BatchNorm sees its input) with seeded random weights and BN
    statistics from data (``calibrate_`` on ``calib``, an NTU-shaped anno
    unless given), and ``cfg_of(True)``'s model (K7) with the same
    weights; and the test pipeline."""
    from dsgcn_tpu_torch.apis import init_recognizer
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    torch.manual_seed(seed)
    base = init_recognizer(cfg_of(False), device=dev)
    pipeline = build_pipeline(base.cfg["data"]["test"]["pipeline"])
    calib = synthetic_annos(seed=1)[0] if calib is None else calib
    calibrate_(base, torch.from_numpy(pipeline(copy.deepcopy(calib))[
        "keypoint"]).to(dev), seed=seed)
    k7 = init_recognizer(cfg_of(True), device=dev)
    k7.load_state_dict(base.state_dict(), strict=True)
    return base, k7, pipeline


def serve_pair(dev, card, out, name, cfg_of, annos, calib, seed,
               logits_shape, shape, per_forward, has_k7=True):
    """A config through init_recognizer / inference_recognizer: the
    ``cfg_of(True)`` model (K7 where ``has_k7``) on ``annos``, its launches
    ``per_forward``, each request's logits of ``logits_shape`` (clips,
    classes) and finite, GPU top-1 equal to the CPU's with logits within 1e-3,
    logits within 1e-4 of the same weights without K7, request latency,
    clips/s of a ``shape`` batch in f32 and bf16 with and without K7.
    Returns the launch counts of the requests."""
    from dsgcn_tpu_torch.apis import (inference_recognizer, init_recognizer,
                                      to_bf16_inference)
    from dsgcn_tpu_torch.models.recognizer import average_clip
    base, model, pipeline = k7_model_pair(dev, cfg_of, seed, calib)
    if not has_k7:                  # cfg_of(True) is cfg_of(False)
        base = None
    out.update(requests=[])
    reset_counts()
    answers, request_ms = [], []
    for a in annos:
        t0 = time.perf_counter()
        answers.append(inference_recognizer(model, a))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    expect_counts(counts, per_forward, len(annos), name)
    cpu = init_recognizer(cfg_of(has_k7), device="cpu")
    cpu.load_state_dict(model.state_dict(), strict=True)
    for a, ans in zip(annos, answers):
        g, c = logits_of(model, pipeline, a), logits_of(cpu, pipeline, a)
        err = rel_err(g, c)
        cpu_top1 = int(average_clip(c[None], "prob")[0].argmax())
        row = dict(request=a["frame_dir"], top5=ans, cpu_top1=cpu_top1,
                   logits_rel_err=err)
        check(g.shape == logits_shape and bool(torch.isfinite(g).all()),
              f"{name} logits of shape {tuple(g.shape)} or not finite")
        check(ans[0][0] == cpu_top1,
              f"{name} GPU top-1 {ans[0]} != CPU top-1 {cpu_top1}")
        check(err <= 1e-3, f"{name} GPU logits off the CPU's by {err:.3e}")
        if base is not None:
            row["vs_module_rel_err"] = rel_err(g, logits_of(base, pipeline,
                                                            a))
            check(row["vs_module_rel_err"] <= 1e-4,
                  f"{name} K7 logits off the module path's by "
                  f"{row['vs_module_rel_err']:.3e}")
        print(f"{name} request", json.dumps(row), flush=True)
        out["requests"].append(row)
    print(f"{name} request latency ms: " + ", ".join(
        f"{ms:.3f}" for ms in request_ms) + f" on {card}", flush=True)
    out.update(request_ms=request_ms, counts=counts)
    del cpu
    for tag, m in (("k7" if has_k7 else "module", model), ("module", base)):
        if m is not None:
            out[tag] = {}
            throughput(m, to_bf16_inference(m), dev, card, out[tag],
                       f"{name} {tag} ", shape, logits_shape[1])
    return counts


def serve_stgcnpp(dev, card, report):
    """Phase 12: STGCN++ (the j config with tcn_use_pallas=True) through
    init_recognizer / inference_recognizer (``serve_pair``): 10 K7
    launches per forward and no other kernel, GPU top-1 equal to the CPU's
    with logits within 1e-3, logits within 1e-4 of the same weights
    without K7, request latency, clips/s of a batch forward in f32 and
    bf16 with and without K7, each with a profile.  Returns the launch
    counts of the four requests."""
    from dsgcn_tpu_torch.models.builder import build_model
    from dsgcn_tpu_torch.ops.tcn import MSTCN
    backbone = build_model(stgcnpp_config(True)["model"]).backbone
    tcns = [getattr(backbone, f"block{i}").tcn
            for i in range(backbone.num_blocks)]
    check(len(tcns) == 10 and all(isinstance(t, MSTCN) and t.use_pallas
                                  for t in tcns),
          "STGCN++ has not ten MSTCN blocks with K7")
    out = report["stgcnpp_serving"] = {}
    return serve_pair(dev, card, out, "STGCN++", stgcnpp_config,
                      synthetic_annos(seed=2), synthetic_annos(seed=1)[0],
                      12, (10, 60), THROUGHPUT_BATCH,
                      {"fused_dgmstcn_eval": 10})


def serve_with_k7(dev, card, report):
    """Phase 13: DG-STGCN ('auto') and DS-GCN with tcn_use_pallas=True: 10
    K7 launches per forward beside their GCN kernels' (as phases 9 and 3
    count them), logits within 1e-4 of the same weights without K7, clips/s
    in f32 and bf16.  Returns the launch counts by model."""
    from dsgcn_tpu_torch.apis import to_bf16_inference
    from dsgcn_tpu_torch.configs.config import Config
    models = {
        "dgstgcn": (lambda k7: with_k7(dg_config(), k7), DG_AUTO),
        "dsgcn": (lambda k7: with_k7(Config.fromfile(str(CONFIG)), k7),
                  {"bd_dyn_graph_agg": 10}),
    }
    results = {}
    for key, (cfg_of, gcn) in models.items():
        out = report[f"{key}_k7"] = {}
        base, model, pipeline = k7_model_pair(dev, cfg_of, seed=13)
        annos = synthetic_annos(seed=2)
        reset_counts()
        logits = [logits_of(model, pipeline, a) for a in annos]
        torch.cuda.synchronize()
        counts = results[key] = read_counts()
        expect_counts(counts, dict(gcn, fused_dgmstcn_eval=10), len(annos),
                      f"{key} with K7")
        errs = [rel_err(lg, logits_of(base, pipeline, a))
                for lg, a in zip(logits, annos)]
        print(f"{key} with K7: launches {json.dumps(counts)}; logits vs "
              "no K7 rel err " + ", ".join(f"{e:.3e}" for e in errs),
              flush=True)
        check(max(errs) <= 1e-4,
              f"{key} K7 logits off the module path's by {max(errs):.3e}")
        out.update(counts=counts, logits_rel_err=errs)
        throughput(model, to_bf16_inference(model), dev, card, out,
                   tag=f"{key} k7 ")
        del base, model
    return results


# ---------------------------------------------------------------------------
# phase 14: STGCN++ training
# ---------------------------------------------------------------------------

def train_stgcnpp(dev, card, report):
    """Phase 14: STGCN++ (the j config with tcn_use_pallas=True, which
    training ignores) through train_step at the config's batch (16 x M2 x
    T100) from its RepeatDataset train set on a synthetic pickle: one GPU
    step against the CPU's (phase 7's criteria), then timed f32 steps with
    their peak memory, launching no kernel of the port at all."""
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    cfg = stgcnpp_config(True)
    check(cfg["data"]["videos_per_gpu"] == 16 and cfg["clip_len"] == 100,
          "the STGCN++ j config is not b16 x T100")
    out = report["stgcnpp_train"] = dict(steps=[])
    batches, cpu_batch = repeat_batches(cfg, seed=14)
    model = init_weights_(build_model(cfg["model"]),
                          torch.Generator().manual_seed(14)).to(dev)
    gpu_vs_cpu_step(model, cpu_batch, out)
    timed_steps(model, batches, "f32", card, out, {})


def repeat_batches(cfg, seed):
    """The host batches of a config whose train set is NTU's
    ``RepeatDataset(times=5)``, at the config's batch, from 32 synthetic
    annos (24 in the train split) through its train pipeline and the
    Loader: 1 + TRAIN_STEPS batches of epoch 0, and CPU_CHECK_CLIPS clips
    of epoch 1 for the CPU check."""
    import itertools
    import tempfile
    from dsgcn_tpu_torch.data.dataset import (Loader, RepeatDataset,
                                              build_dataset,
                                              make_synthetic_pose_dataset)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "synth.pkl")
        make_synthetic_pose_dataset(num_samples=32, num_classes=60, t=100,
                                    seed=seed, path=path)
        train = dict(cfg["data"]["train"])
        train["dataset"] = dict(train["dataset"], ann_file=path,
                                split="train")
        loader = Loader(build_dataset(train),
                        batch_size=cfg["data"]["videos_per_gpu"], seed=seed,
                        drop_last=True, num_workers=8)
        check(isinstance(loader.dataset, RepeatDataset)
              and len(loader.dataset) == 5 * 24, "not RepeatDataset(5)")
        batches = [as_batch(b) for b in itertools.islice(
            loader.epoch(0), 1 + TRAIN_STEPS)]
        cpu_batch = as_batch(next(loader.epoch(1)), CPU_CHECK_CLIPS)
    return batches, cpu_batch


# ---------------------------------------------------------------------------
# phase 15: every committed DS-GCN config: K1-K3 at V = 17, the four NTU
# streams through the CLIs, COCO serving and a COCO training step
# ---------------------------------------------------------------------------

DSGCN_DIR = ROOT / "configs" / "dsgcn"
COCO_V = 17
# skeletons a call: b32 x M2 (the hrnet configs' videos_per_gpu) and fight
# detection's b32 x M5; the per-forward and per-step sums take the first
COCO_N = (64, 160)
COCO_THROUGHPUT_BATCH = (64, 2, 100, COCO_V, 3)
STREAMS = ("j", "b", "jm", "bm")
STREAM_CPU_SAMPLES = 1   # of the first test batch, scored on the CPU too
FUSE_WEIGHTS = (2.0, 2.0, 1.0, 1.0)


def coco_kernel_checks(dev, rng, report):
    """Phase 15(a): K3, K1 and K2 on the COCO graph (17 joints inside the
    compile-time bound 25, no v_real) at the hrnet DS-GCN blocks (T 100 at
    the first GCN, 10 blocks), N = 64 and 160, f32 and bf16, edge attention
    on subset 1 with COCO's classes: phase 2's rules for K3 and K1 (K1's
    bf16 outputs with ``graph_flips``), phase 6's for K2.  f32 cases timed
    (ms, plain, library, bound) and summed over the blocks per N: K3 per
    forward, K1 and K2 per step."""
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import fused_dyn_graph_agg_bwd
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
    names = ("bd_dyn_graph_agg", "fused_dyn_graph_agg",
             "fused_dyn_graph_agg_bwd")
    worst = dict.fromkeys(names, 0.0)
    sums = {N: {n: new_sum() for n in names} for N in COCO_N}
    rows = report["coco_kernel_checks"] = []
    for N in COCO_N:
        for Cm, T, nblocks in BLOCK_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                d = block_inputs(rng, dev, Cm, T, dtype, Vp=COCO_V, N=N,
                                 layout="coco")
                d["dy"] = torch.randn(d["pre"].shape, generator=rng,
                                      device=dev).to(dtype)
                base = dict(Cm=Cm, T=T, N=N, V=COCO_V, edge=True,
                            dtype=str(dtype).split(".")[-1],
                            blocks=nblocks)
                calls = kernel_calls(d, Cm, True)
                for name in names[:2]:
                    kern, plain, library = calls[name]
                    row = dict(base, kernel=name)
                    flips = (graph_flips(d, Cm, True) if dtype ==
                             torch.bfloat16 and name == names[1] else None)
                    compare(name, kern(), plain(), dtype, row, flips)
                    if dtype == torch.float32:
                        bound_ms, bound_by = bound(d, name, Cm, True)
                        row.update(ms=cold_ms(kern, flush=flush),
                                   plain_ms=cold_ms(plain, iters=3,
                                                    flush=flush),
                                   library_ms=cold_ms(library, flush=flush),
                                   bound_ms=bound_ms, bound_by=bound_by)
                        with_ratios(row)
                    rows.append(row)
                args = k2_args(d, Cm, True)
                row = dict(base, kernel=names[2])
                compare_k2(fused_dyn_graph_agg_bwd(*args),
                           k2_refs(d, args, Cm, True, dtype), dtype, row)
                if dtype == torch.float32:
                    row.update(k2_times(d, args, Cm, flush))
                    with_ratios(row)
                rows.append(row)
                for r in rows[-3:]:
                    worst[r["kernel"]] = max(worst[r["kernel"]],
                                             r["max_abs_err"])
                    if "ms" in r:
                        add_to(sums[N][r["kernel"]], r, nblocks)
                    print("kernel", json.dumps(r), flush=True)
                del d
    for N in COCO_N:
        print(f"V = 17, N = {N}, per forward (K3) / per step (K1, K2): "
              + json.dumps(sums[N], default=sorted), flush=True)
    report["coco_per_forward"] = sums
    return worst, sums


def run_module(args, what, timeout=600):
    """``python -m`` one of the port's CLIs from the repository root; its
    standard output (checked: exit code 0)."""
    return run_modules([(args, what)], timeout)[0]


def run_modules(jobs, timeout=600):
    """``run_module`` for each (args, what) of ``jobs``, all started
    together (each is mostly process start-up; the card holds them all);
    their standard outputs, in order."""
    t0 = time.perf_counter()
    procs = [(subprocess.Popen([sys.executable, "-m", *map(str, args)],
                               cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True), what)
             for args, what in jobs]
    outs = []
    try:
        for proc, what in procs:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            print(f"{what}: rc {proc.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for line in stdout.splitlines()[-5:]:
                print(f"  cli: {line}", flush=True)
            check(proc.returncode == 0, f"{what} failed:\n{stderr[-3000:]}")
            outs.append(stdout)
    finally:                        # a failed check stops the others too
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def printed_value(stdout, key):
    return next(line.split(": ", 1)[1] for line in stdout.splitlines()
                if line.startswith(f"{key}: "))


def scores_on_cpu(cfg_path, work_dir, n):
    """The first ``n`` test samples' clip-averaged scores of the latest
    checkpoint in ``work_dir``, on the CPU (the plain versions)."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.checkpoint import CheckpointManager
    from dsgcn_tpu_torch.data.dataset import Loader, build_dataset
    from dsgcn_tpu_torch.models.builder import build_model
    from dsgcn_tpu_torch.core.trainer import clip_scores
    cfg = Config.fromfile(str(cfg_path))
    model = build_model(cfg["model"])
    CheckpointManager(str(work_dir)).restore(model)
    ds = build_dataset(cfg["data"]["test"], test_mode=True)
    ds.video_infos = ds.video_infos[:n]
    loader = Loader(ds, batch_size=n, shuffle=False, num_workers=4)
    return clip_scores(model.eval(), loader)[0]


def four_streams(tmp, report, cfg_dir=DSGCN_DIR / "ntu60_xsub_3dkp",
                 streams=STREAMS, weights=FUSE_WEIGHTS,
                 per_forward=(("bd_dyn_graph_agg", 10),),
                 key="four_streams"):
    """Phase 15(b): the j, b, jm and bm NTU configs
    (``configs/dsgcn/ntu60_xsub_3dkp``, full width) on a synthetic pickle
    through the CLIs on the card, the streams side by side: one short
    training epoch (3 steps of 16) with ``--test-last``, the test CLI (10
    K3 launches a forward; its first STREAM_CPU_SAMPLES samples' scores,
    10 clips each, within 1e-3 of the same checkpoint on the CPU),
    then
    the fusion at 2:2:1:1, equal to the numpy sum of the four pickles and
    printing its metrics.  Phase 16 takes the ``streams`` of another
    ``cfg_dir`` with other ``weights`` and kernel launches
    (``per_forward``: (wrapper, launches a forward) pairs)."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.metrics import evaluate
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    ann = tmp / f"{key}.pkl"
    make_synthetic_pose_dataset(num_samples=64, num_classes=60, t=100,
                                seed=15, path=str(ann))
    test_batch, n_cpu = 4, STREAM_CPU_SAMPLES
    out = report[key] = {}
    cfgs, wds, pkls = {}, {}, []
    for s in streams:
        base = cfg_dir / f"{s}.py"
        train = f"dict(ann_file={str(ann)!r}, split='train')"
        if Config.fromfile(str(base))["data"]["train"]["type"] == \
                "RepeatDataset":
            train = f"dict(times=1, dataset={train})"
        cfgs[s] = tmp / f"{key}_{s}.py"
        cfgs[s].write_text(
            f"_base_ = [{str(base)!r}]\n"
            "data = dict(videos_per_gpu=16, workers_per_gpu=4,\n"
            f"    test_dataloader=dict(videos_per_gpu={test_batch}),\n"
            f"    train={train},\n"
            f"    val=dict(ann_file={str(ann)!r}, split='val'),\n"
            f"    test=dict(ann_file={str(ann)!r}, split='val'))\n")
        wds[s] = tmp / f"wd_{key}_{s}"
        pkls.append(tmp / f"s_{key}_{s}.pkl")
    # the streams' CLIs run side by side: each trains its own work dir
    trained = run_modules([(["dsgcn_tpu_torch.tools.train", cfgs[s],
                             "--work-dir", wds[s], "--total-epochs", "1",
                             "--test-last"], f"train CLI, stream {s}")
                           for s in streams])
    for s, stdout in zip(streams, trained):
        check("final: {" in stdout, f"stream {s}: no 'final:' line")
    tested = run_modules([(["dsgcn_tpu_torch.tools.test", cfgs[s], wds[s],
                            "--out", pkl], f"test CLI, stream {s}")
                          for s, pkl in zip(streams, pkls)])
    for s, pkl, stdout in zip(streams, pkls, tested):
        line = printed_value(stdout, "forwards")
        forwards = int(line.split(",")[0])
        launches = json.loads(line.split("kernel launches: ", 1)[1])
        expect_counts(launches, dict(per_forward), forwards,
                      f"the {s} stream's test CLI")
        got = load_pickle(pkl)
        check(got["scores"].shape == (16, 60)
              and bool(np.isfinite(got["scores"]).all()),
              f"stream {s} scores {got['scores'].shape}")
        cpu = scores_on_cpu(cfgs[s], wds[s], n_cpu)
        err = float(np.abs(got["scores"][:n_cpu] - cpu).max()
                    / np.abs(cpu).max())
        print(f"stream {s}: {forwards} forwards, launches "
              f"{json.dumps(launches)}, first batch's scores vs CPU rel err "
              f"{err:.3e}", flush=True)
        check(err <= 1e-3, f"stream {s} scores off the CPU's by {err:.3e}")
        out[s] = dict(forwards=forwards, launches=launches, cpu_rel_err=err,
                      top1=float(printed_value(stdout, "top1_acc")))
    fused_pkl = tmp / f"fused_{key}.pkl"
    stdout = run_module(["dsgcn_tpu_torch.tools.fuse_scores", *pkls,
                         "--weights", *weights, "--out", fused_pkl],
                        "fuse CLI, " + ":".join(f"{w:g}" for w in weights))
    parts = [load_pickle(p) for p in pkls]
    want = None
    for w, p in zip(weights, parts):
        want = p["scores"] * w if want is None else want + p["scores"] * w
    fused = load_pickle(fused_pkl)
    check(np.array_equal(fused["scores"], want),
          "fused scores differ from the numpy sum of the four pickles")
    metrics = evaluate(want, parts[0]["labels"],
                       ("top_k_accuracy", "mean_class_accuracy"))
    for k, v in metrics.items():
        check(printed_value(stdout, k) == f"{float(v):.4f}",
              f"fuse CLI printed {k} {printed_value(stdout, k)}, numpy "
              f"{v:.4f}")
    print(f"{len(streams)}-stream fusion equals the numpy sum; "
          f"{json.dumps(metrics)}", flush=True)
    out["fused"] = metrics


def coco_serving(dev, card, report):
    """Phase 15(c): the hrnet configs kinetics400_hrnet/{j,b}.py and
    fight_detection/j.py (M = 5) at full width on synthetic compressed
    annos (DecompressPose, PoseCompact, COCO GenSkeFeat) through
    init_recognizer / inference_recognizer: 10 K3 launches a request, GPU
    top-1 equal to the CPU's, logits within 1e-3; request latency; for
    kinetics j, clips/s and profiles of a (64, 2, 100, 17, 3) batch in
    f32 and bf16.  Returns the launch counts of all requests."""
    from dsgcn_tpu_torch.apis import (inference_recognizer, init_recognizer,
                                      to_bf16_inference)
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.data.dataset import make_compressed_pose_anno
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.models.recognizer import average_clip
    out = report["coco_serving"] = {}
    total = {}
    for name in ("kinetics400_hrnet/j.py", "kinetics400_hrnet/b.py",
                 "fight_detection/j.py"):
        cfg = Config.fromfile(str(DSGCN_DIR / name))
        torch.manual_seed(15)
        model = init_recognizer(cfg, device=dev)
        pipeline = build_pipeline(cfg["data"]["test"]["pipeline"])
        calibrate_(model, torch.from_numpy(pipeline(make_compressed_pose_anno(
            seed=0, t=150))["keypoint"]).to(dev), seed=15)
        classes = cfg["model"]["cls_head"]["num_classes"]
        annos = [make_compressed_pose_anno(seed=s, t=t, frame_dir=f"H{s}")
                 for s, t in ((1, 150), (2, 90))]
        reset_counts()
        answers, request_ms = [], []
        for a in annos:
            t0 = time.perf_counter()
            answers.append(inference_recognizer(model, a))
            request_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        expect_counts(counts, {"bd_dyn_graph_agg": 10}, len(annos),
                      f"{name} serving")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        cpu = init_recognizer(cfg, device="cpu")
        cpu.load_state_dict(model.state_dict(), strict=True)
        rows = []
        for a, ans in zip(annos, answers):
            g, c = logits_of(model, pipeline, a), logits_of(cpu, pipeline, a)
            check(g.shape == (10, classes) and bool(torch.isfinite(g).all()),
                  f"{name} logits of shape {tuple(g.shape)} or not finite")
            err = rel_err(g, c)
            cpu_top1 = int(average_clip(c[None], "prob")[0].argmax())
            print(f"{name} request {a['frame_dir']}: gpu top-5 {ans}; cpu "
                  f"top-1 {cpu_top1}; logits rel err {err:.3e}", flush=True)
            check(ans[0][0] == cpu_top1,
                  f"{name} GPU top-1 {ans[0]} != CPU top-1 {cpu_top1}")
            check(err <= 1e-3, f"{name} GPU logits off the CPU's by {err:.3e}")
            rows.append(dict(request=a["frame_dir"], top5=ans,
                             cpu_top1=cpu_top1, logits_rel_err=err))
        print(f"{name} request latency ms (f32): "
              + ", ".join(f"{ms:.3f}" for ms in request_ms), flush=True)
        out[name] = dict(requests=rows, request_ms=request_ms, counts=counts,
                         bodies=pipeline(dict(annos[0]))["keypoint"].shape[1])
        if name == "kinetics400_hrnet/j.py":
            throughput(model, to_bf16_inference(model), dev, card, out[name],
                       "coco ", COCO_THROUGHPUT_BATCH, classes)
        del model, cpu
    check(out["fight_detection/j.py"]["bodies"] == 5,
          "fight detection does not serve 5 bodies")
    return total


def coco_train(dev, card, report, tmp):
    """Phase 15(d): the hrnet b config (kinetics400_hrnet/b.py) at its
    batch, b32 x M2 x T100 x V17, from synthetic compressed annos through
    its train pipeline and the Loader: one step on the card against the
    same step on the CPU (phase 7's criteria), then timed f32 steps, each
    launching K1 and K2 once a block.  Returns the launch counts of the
    timed steps."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.data.dataset import (Loader, build_dataset,
                                              make_compressed_pose_anno)
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    cfg = Config.fromfile(str(DSGCN_DIR / "kinetics400_hrnet" / "b.py"))
    batch = cfg["data"]["videos_per_gpu"]
    check(batch == 32 and cfg["clip_len"] == 100,
          "the hrnet b config is not b32 x T100")
    annos = [make_compressed_pose_anno(seed=100 + i, t=120, label=i % 400,
                                       frame_dir=f"C{i:04d}")
             for i in range((1 + TRAIN_STEPS) * batch)]
    path = tmp / "coco_train.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(split={"train": [a["frame_dir"] for a in annos]},
                         annotations=annos), f)
    loader = Loader(build_dataset(dict(cfg["data"]["train"],
                                       ann_file=str(path))),
                    batch_size=batch, seed=15, drop_last=True, num_workers=8)
    batches = [as_batch(b) for b in loader.epoch(0)]
    check(len(batches) == 1 + TRAIN_STEPS
          and batches[0]["keypoint"].shape == (batch, 2, 100, COCO_V, 3),
          f"coco batches {batches[0]['keypoint'].shape}")
    cpu_batch = as_batch(next(loader.epoch(1)), CPU_CHECK_CLIPS)
    gen = torch.Generator().manual_seed(15)
    model = init_weights_(build_model(cfg["model"]), gen)
    nudge_gates_(model, gen)
    model = model.to(dev)
    out = report["coco_train"] = dict(steps=[])
    gpu_vs_cpu_step(model, cpu_batch, out)
    reset_counts()
    timed_steps(model, batches, "f32", card, out,
                {"fused_dyn_graph_agg": 10, "fused_dyn_graph_agg_bwd": 10})
    return read_counts()


def every_config(dev, card, rng, report):
    """Phase 15.  Returns (worst errors, per-forward/step sums by N, launch
    counts of COCO serving, launch counts of COCO training)."""
    import tempfile
    worst, sums = coco_kernel_checks(dev, rng, report)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        four_streams(tmp, report)
        serve_counts = coco_serving(dev, card, report)
        train_counts = coco_train(dev, card, report, tmp)
    return worst, sums, serve_counts, train_counts


# ---------------------------------------------------------------------------
# phase 16: AAGCN and CTR-GCN, the committed j configs: serving (NTU and
# hrnet), training, and the train, test and fuse CLIs
# ---------------------------------------------------------------------------

FAMILIES = ("aagcn", "ctrgcn")
FAMILY_CPU_REQUESTS = 1             # of the served requests, on the CPU too


def family_config(family, data="ntu60_xsub_3dkp", stream="j"):
    return ROOT / "configs" / family / data / f"{stream}.py"


def family_serving(dev, card, family, data, annos, calib, seed, tmp, out,
                   shape=None):
    """A committed config of a family through init_recognizer (a
    checkpoint of seeded ``init_weights_`` weights, then BN statistics from
    data, ``calibrate_``) and inference_recognizer: no kernel of the port
    launched, each request's wall ms, and on the first
    FAMILY_CPU_REQUESTS requests GPU top-1 equal to the CPU's and logits
    within 1e-3 of them; with ``shape``, clips/s of a batch forward in f32
    and bf16 with profiles."""
    from dsgcn_tpu_torch.apis import (inference_recognizer, init_recognizer,
                                      to_bf16_inference)
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    from dsgcn_tpu_torch.models.recognizer import average_clip
    name = f"{family} {data}"
    cfg = Config.fromfile(str(family_config(family, data)))
    ckpt = tmp / f"{family}_{data}.pt"
    torch.save(init_weights_(build_model(cfg["model"]),
                             torch.Generator().manual_seed(seed))
               .state_dict(), ckpt)
    model = init_recognizer(cfg, checkpoint=str(ckpt), device=dev)
    check(type(model.backbone).__name__ == family.upper()
          and model.backbone.num_blocks == 10,
          f"{name}: not a 10-block {family.upper()}")
    pipeline = build_pipeline(cfg["data"]["test"]["pipeline"])
    calibrate_(model, torch.from_numpy(pipeline(copy.deepcopy(calib))[
        "keypoint"]).to(dev), seed=seed)
    classes = cfg["model"]["cls_head"]["num_classes"]
    before = read_counts()
    answers, request_ms = [], []
    for a in annos:
        t0 = time.perf_counter()
        answers.append(inference_recognizer(model, a))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: n - before[k] for k, n in read_counts().items()}
    expect_counts(counts, {}, len(annos), f"{name} serving")
    cpu = init_recognizer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict(), strict=True)
    rows = []
    for a, ans in list(zip(annos, answers))[:FAMILY_CPU_REQUESTS]:
        g, c = logits_of(model, pipeline, a), logits_of(cpu, pipeline, a)
        check(g.shape == (10, classes) and bool(torch.isfinite(g).all()),
              f"{name} logits of shape {tuple(g.shape)} or not finite")
        err = rel_err(g, c)
        cpu_top1 = int(average_clip(c[None], "prob")[0].argmax())
        print(f"{name} request {a['frame_dir']}: gpu top-5 {ans}; cpu top-1 "
              f"{cpu_top1}; logits rel err {err:.3e} (max |logit| "
              f"{c.abs().max().item():.3f})", flush=True)
        check(ans[0][0] == cpu_top1,
              f"{name} GPU top-1 {ans[0]} != CPU top-1 {cpu_top1}")
        check(err <= 1e-3, f"{name} GPU logits off the CPU's by {err:.3e}")
        rows.append(dict(request=a["frame_dir"], top5=ans, cpu_top1=cpu_top1,
                         logits_rel_err=err))
    print(f"{name} request latency ms (f32, 10 clips x 2 bodies x 100 "
          f"frames): " + ", ".join(f"{ms:.3f}" for ms in request_ms)
          + f" on {card}", flush=True)
    out[data] = dict(requests=rows, request_ms=request_ms, counts=counts)
    if shape is not None:
        throughput(model, to_bf16_inference(model), dev, card, out[data],
                   f"{family} ", shape, classes)
    del model, cpu


def family_train(dev, card, family, out):
    """The family's NTU j config at its batch, b16 x M2 x T100, from its
    RepeatDataset train set, gates and units nudged (``nudge_gates_``,
    ``nudge_units_``): one GPU step against the CPU's (phase 7's
    criteria), then timed f32 steps with their peak device memory, no
    kernel of the port launched."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    cfg = Config.fromfile(str(family_config(family)))
    check(cfg["data"]["videos_per_gpu"] == 16 and cfg["clip_len"] == 100,
          f"the {family} j config is not b16 x T100")
    batches, cpu_batch = repeat_batches(cfg, seed=16)
    gen = torch.Generator().manual_seed(16)
    model = init_weights_(build_model(cfg["model"]), gen)
    nudge_gates_(model, gen)
    nudge_units_(model, gen)
    model = model.to(dev)
    out["train"] = dict(steps=[])
    gpu_vs_cpu_step(model, cpu_batch, out["train"])
    timed_steps(model, batches, "f32", card, out["train"], {})


def families(dev, card, report):
    """Phase 16: for AAGCN and CTR-GCN, the NTU j config serving four
    requests (10 clips x M2 x T100, GPU against CPU) and a (64, 2, 100,
    25, 3) batch in f32 and bf16, the hrnet j config (V = 17, the COCO
    graph) serving two synthetic hrnet annos, and training steps at the
    config's batch; then CTR-GCN's j and b streams through the train
    (--test-last), test and fuse CLIs.  No kernel of the port is on these
    paths (nor a Pallas kernel on JAX's)."""
    import tempfile
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    hrnet = make_synthetic_pose_dataset(num_samples=3, num_classes=60,
                                        t=120, seed=16,
                                        layout="coco")["annotations"]
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for family in FAMILIES:
            out = report.setdefault("families", {})[family] = {}
            family_serving(dev, card, family, "ntu60_xsub_3dkp",
                           synthetic_annos(seed=2), synthetic_annos(seed=1)[0],
                           16, tmp, out, THROUGHPUT_BATCH)
            family_serving(dev, card, family, "ntu60_xsub_hrnet", hrnet[1:],
                           hrnet[0], 16, tmp, out)
            family_train(dev, card, family, out)
        counts = read_counts()
        expect_counts(counts, {}, 1, "phase 16's serving and training")
        four_streams(tmp, report, family_config("ctrgcn").parent,
                     streams=("j", "b"), weights=(1.0, 1.0), per_forward=(),
                     key="ctrgcn_streams")
    print("phase 16: every AAGCN and CTR-GCN forward and step launched no "
          f"kernel of the port (K1-K7): {json.dumps(counts)}", flush=True)


# ---------------------------------------------------------------------------
# phase 17: the gesture config and the STGCN family's hrnet configs (K7 at
# V = 21 and 17), validation by default in the train CLI, and the main path's
# options: DGMSTCN's eval layouts, remat, target_specific, ada_attention
# and per-frame graphs
# ---------------------------------------------------------------------------

GESTURE_CONFIG = ROOT / "configs" / "gesture" / "stgcnpp_hand.py"
HAND_V = 21
GESTURE_BATCH = (64, 1, 10, HAND_V, 2)    # clips, hands, frames, joints, xy
# the gesture model's temporal units at b64 x M1 x T10 (N = 64 skeletons):
# (C, T in, stride, blocks); the stride-2 unit's output has T = 5, and a
# T = 5 unit is checked besides (no block of the path has one)
HAND_TCN_SHAPES = [(64, 10, 1, 5), (128, 10, 2, 1), (128, 5, 1, 0)]
HRNET_N = 128                             # b64 x M2 serving
LAYOUT_BATCHES = (16, 64)                 # clips; x M2 skeletons
OPTION_BATCH = 16
OPTION_CPU_REQUESTS = 1            # of the two served requests, on the CPU


def hand_annos(seed, n=4):
    """One-hand MediaPipe annotations as ``GestureDataset`` leaves them:
    2D keypoints (1, T, 21, 2) in normalized image coordinates, a hand
    pose moving along a smooth per-request path, 12 to 30 frames."""
    rng = np.random.default_rng(seed)
    annos = []
    for i in range(n):
        t = int(rng.integers(12, 31))
        pose = 0.5 + 0.1 * rng.standard_normal((1, 1, HAND_V, 2))
        phase = np.linspace(0, (1 + i) * np.pi, t)[None, :, None, None]
        kp = (pose + 0.05 * np.sin(phase + rng.uniform(0, np.pi, pose.shape))
              + 0.005 * rng.standard_normal((1, t, HAND_V, 2)))
        annos.append(dict(frame_dir=f"H{i:04d}", label=int(i % 40),
                          keypoint=kp.astype(np.float32), total_frames=t))
    return annos


def gesture_batches(cfg, tmp, batch):
    """Synthetic hand annotations in a gesture pickle (split 'train'; the
    config trains on 'train+val'), through the config's train pipeline,
    GestureDataset and the Loader at ``batch``: 1 + TRAIN_STEPS batches."""
    from dsgcn_tpu_torch.data.dataset import (GestureDataset, Loader,
                                              build_dataset)
    annos = hand_annos(seed=170, n=(1 + TRAIN_STEPS) * batch)
    for a in annos:                  # x, y, score as the pickle holds them
        kp = a["keypoint"]
        a["keypoint"] = np.concatenate([kp, np.ones_like(kp[..., :1])], -1)
    path = tmp / "gesture.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(split=dict(train=[a["frame_dir"] for a in annos],
                                    val=[], test=[]), annotations=annos), f)
    loader = Loader(build_dataset(dict(cfg["data"]["train"],
                                       ann_file=str(path))),
                    batch_size=batch, seed=17, drop_last=True, num_workers=8)
    check(isinstance(loader.dataset, GestureDataset), "not GestureDataset")
    batches = [as_batch(b) for b in loader.epoch(0)]
    check(len(batches) == 1 + TRAIN_STEPS
          and batches[0]["keypoint"].shape == (batch, 1, 10, HAND_V, 2),
          f"gesture batches {batches[0]['keypoint'].shape}")
    return batches


def gesture(dev, card, report, tmp):
    """Phase 17(a): configs/gesture/stgcnpp_hand.py at full width (STGCN++
    on the MediaPipe hand, V = 21, 2D, clip 10, 40 classes): serving with
    K7 (6 launches a forward), GPU against CPU, against the module path,
    clips/s of a (64, 1, 10, 21, 2) batch with and without K7 in f32 and
    bf16; K7 at the hand shapes against its plain version; a b64 step on
    the card against the CPU's, then timed steps (no kernel)."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    cfg_of = lambda k7: with_k7(Config.fromfile(str(GESTURE_CONFIG)),  # noqa
                                k7)
    cfg = cfg_of(False)
    model = build_model(cfg["model"])
    check(model.backbone.num_blocks == 6
          and sum(p.numel() for p in model.parameters()) == 197_478,
          "the gesture model is not the 6-block, 197,478-parameter STGCN++")
    out = report["gesture"] = {}
    annos = hand_annos(seed=17, n=5)
    counts = serve_pair(dev, card, out, "gesture", cfg_of, annos[1:],
                        annos[0], 17, (1, 40), GESTURE_BATCH,
                        {"fused_dgmstcn_eval": 6})
    worst, per_forward = k7_path_checks(dev, report, "gesture",
                                        HAND_TCN_SHAPES, HAND_V,
                                        GESTURE_BATCH[0], coeff=False)
    batch = cfg["data"]["videos_per_gpu"]
    check(batch == 64, f"the gesture config's batch is {batch}, not 64")
    batches = gesture_batches(cfg, tmp, batch)
    model = init_weights_(model, torch.Generator().manual_seed(17)).to(dev)
    out["train"] = dict(steps=[])
    gpu_vs_cpu_step(model, batches[0], out["train"])
    timed_steps(model, batches, "f32", card, out["train"], {})
    return worst, per_forward, counts


def hrnet_family(dev, card, report):
    """Phase 17(b): the ST-GCN and STGCN++ hrnet j configs
    (configs/{stgcn,stgcnpp}/ntu60_xsub_hrnet/j.py, COCO V = 17) serving
    two synthetic hrnet annos (GPU against CPU) and a (64, 2, 100, 17, 3)
    batch: STGCN++ with K7 (10 launches a forward) and without; ST-GCN's
    temporal unit is ``unit_tcn``, which no kernel computes (in JAX or the
    port), so it serves without K7 and launches nothing.  Then K7 at
    STGCN++'s temporal unit shapes at V = 17 against its plain version.
    Returns the worst K7 error, its sums per forward and the STGCN++
    launch counts."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    hrnet = make_synthetic_pose_dataset(num_samples=3, num_classes=60,
                                        t=120, seed=17,
                                        layout="coco")["annotations"]
    counts = {}
    for family, has_k7 in (("stgcnpp", True), ("stgcn", False)):
        path = ROOT / "configs" / family / "ntu60_xsub_hrnet" / "j.py"
        def cfg_of(k7, path=path, has_k7=has_k7):
            cfg = Config.fromfile(str(path))
            return with_k7(cfg, k7) if has_k7 else cfg
        out = report.setdefault("hrnet", {})[family] = {}
        counts[family] = serve_pair(
            dev, card, out, f"{family} hrnet", cfg_of, hrnet[1:], hrnet[0],
            17, (10, 60), COCO_THROUGHPUT_BATCH,
            {"fused_dgmstcn_eval": 10} if has_k7 else {}, has_k7)
    worst, per_forward = k7_path_checks(dev, report, "stgcnpp_hrnet",
                                        TCN_SHAPES, COCO_V, HRNET_N,
                                        coeff=False)
    return worst, per_forward, counts["stgcnpp"]


def validate_by_default(tmp, report):
    """Phase 17(c), validation by default: the train CLI on the DS-GCN j
    config (which has data.val) without ``--validate``, one epoch of 3
    steps of 16: the log holds a ``mode: val`` record and the checkpoint
    is marked best."""
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    ann = tmp / "val_default.pkl"
    make_synthetic_pose_dataset(num_samples=64, num_classes=60, t=100,
                                seed=17, path=str(ann))
    cfg = tmp / "val_default.py"
    cfg.write_text(f"_base_ = [{str(CONFIG)!r}]\n"
                   "data = dict(videos_per_gpu=16, workers_per_gpu=4,\n"
                   "    test_dataloader=dict(videos_per_gpu=16),\n"
                   f"    train=dict(ann_file={str(ann)!r}, split='train'),\n"
                   f"    val=dict(ann_file={str(ann)!r}, split='val'))\n")
    wd = tmp / "wd_val_default"
    # in this process (a subprocess took ~20 s more to reach the card)
    from dsgcn_tpu_torch.tools import train as train_cli
    train_cli.main([str(cfg), "--work-dir", str(wd), "--total-epochs", "1"])
    torch.cuda.empty_cache()
    records = [json.loads(line) for f in sorted(wd.glob("*.log.jsonl"))
               for line in f.read_text().splitlines()]
    vals = [r for r in records if r.get("mode") == "val"]
    steps = [r["step"] for r in records if r.get("mode") == "train"]
    meta = json.loads((wd / "ckpt" / "3.json").read_text())
    print(f"CLI without --validate: val records {json.dumps(vals)}; "
          f"checkpoint meta {json.dumps(meta)}", flush=True)
    check(len(vals) == 1 and 0 <= vals[0]["top1_acc"] <= 1,
          f"the train CLI did not validate without --validate: {vals}")
    check(meta["best"] and meta["score"] == vals[0]["top1_acc"],
          f"no best checkpoint: {meta}")
    report["validate_by_default"] = dict(val=vals, checkpoint=meta,
                                         train_steps=steps)


def set_layout(model, layout):
    """Every DGMSTCN of ``model`` in the concat layout ('concat') or in K7
    ('k7': ``use_pallas``)."""
    from dsgcn_tpu_torch.ops.tcn import DGMSTCN
    for m in model.modules():
        if isinstance(m, DGMSTCN):
            m.use_pallas = layout == "k7"


def eval_layouts(dev, card, report):
    """Phase 17(d): DS-GCN (the j config, calibrated weights) at b16 and
    b64 x M2 x T100 with every DGMSTCN in the concat layout (which every
    ``eval_layout`` runs) and in K7: ms a forward (5 after 2 warm-ups),
    the profile's busy time and the device's idle share; K7's logits
    within 1e-5 of concat's."""
    from dsgcn_tpu_torch.apis import init_recognizer
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    torch.manual_seed(17)
    model = init_recognizer(str(CONFIG), device=dev)
    pipeline = build_pipeline(model.cfg["data"]["test"]["pipeline"])
    calibrate_(model, torch.from_numpy(pipeline(synthetic_annos(seed=1)[0])[
        "keypoint"]).to(dev), seed=17)
    out = report["eval_layouts"] = {}
    rng = np.random.default_rng(17)
    for b in LAYOUT_BATCHES:
        x = torch.from_numpy(rng.standard_normal((b, 2, 100, V, 3)).astype(
            np.float32)).to(dev)
        rows, logits = {}, {}
        for layout in ("concat", "k7"):
            set_layout(model, layout)
            with torch.inference_mode():
                for _ in range(2):
                    y = model(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    y = model(x)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 5 * 1e3
            logits[layout] = y.float().cpu()
            prof = {}
            breakdown(model, x, layout, prof, f"DS-GCN b{b} ")
            p = prof["profile"][layout]
            rows[layout] = dict(ms_per_forward=ms, clips_per_s=b / ms * 1e3,
                                busy_ms=p.get("busy_ms"),
                                profiled_wall_ms=p.get("wall_ms"),
                                idle_share=(1 - p["busy_ms"] / p["wall_ms"]
                                            if p else None))
        err = rel_err(logits["k7"], logits["concat"])
        rows["k7"]["logits_rel_err_vs_concat"] = err
        check(err <= 1e-5, f"DS-GCN b{b} k7 logits off concat's by "
              f"{err:.3e}")
        out[f"b{b}"] = rows
        print(f"DS-GCN b{b} eval layouts: {json.dumps(rows)} on {card}",
              flush=True)
    del model


def set_remat(model, remat):
    model.backbone.remat = remat
    for m in model.backbone.modules():
        if hasattr(m, "remat_tcn"):
            m.remat_tcn = remat == "tcn"


def bn_stats(model):
    from dsgcn_tpu_torch.ops.common import BatchNorm
    return [t.detach().clone() for m in model.modules()
            if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def remat_steps(dev, card, report, batches):
    """Phase 17(e): DS-GCN and DG-STGCN train steps at b128 x M2 x T60
    with ``remat`` False, 'tcn' and True from the same weights: the first
    step's loss within 1e-5 of the no-remat loss and the running
    statistics it leaves within 1e-6, K1 launched twice a block under
    whole-block remat (20 a step, K2 10), then timed steps with their peak
    device memory."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.train import make_optimizer, train_step
    from dsgcn_tpu_torch.models.builder import (build_model, init_weights_,
                                                set_dropout_generator)
    builds = (("dsgcn", lambda: build_model(Config.fromfile(str(CONFIG))[
        "model"])), ("dgstgcn", build_dgstgcn))
    for key, build in builds:
        gen = torch.Generator().manual_seed(17)
        base = init_weights_(build(), gen)
        nudge_gates_(base, gen)
        base = base.to(dev)
        first = None
        for remat in (False, "tcn", True):
            model = copy.deepcopy(base)
            set_remat(model, remat)
            set_dropout_generator(model, torch.Generator(
                device=dev).manual_seed(17))
            opt, sched = make_optimizer(model, 100)
            reset_counts()
            loss = train_step(model, opt, sched, batches[0])["loss"].item()
            counts = read_counts()
            k1 = 20 if remat is True else 10
            expect_counts(counts, {"fused_dyn_graph_agg": k1,
                                   "fused_dyn_graph_agg_bwd": 10}, 1,
                          f"{key} remat={remat!r} step")
            stats = bn_stats(model)
            row = dict(first_loss=loss, launches=counts)
            if first is None:
                first = (loss, stats)
            else:
                row["loss_rel_err"] = abs(loss - first[0]) / abs(first[0])
                row["stats_max_abs_err"] = max(
                    (a - b).abs().max().item()
                    for a, b in zip(stats, first[1]))
                check(row["loss_rel_err"] <= 1e-5,
                      f"{key} remat={remat!r} loss off by "
                      f"{row['loss_rel_err']:.3e}")
                check(row["stats_max_abs_err"] <= 1e-6,
                      f"{key} remat={remat!r} BN statistics off by "
                      f"{row['stats_max_abs_err']:.3e}")
            out = report.setdefault("remat", {}).setdefault(key, {})
            out[str(remat)] = dict(row, steps=[])
            print(f"{key} remat={remat!r}: {json.dumps(row)}", flush=True)
            # remat's steps: a warm-up and one timed (without remat all)
            timed_steps(model, batches if remat is False else batches[:2],
                        "f32", card, out[str(remat)],
                        {"fused_dyn_graph_agg": k1,
                         "fused_dyn_graph_agg_bwd": 10})
            del model, opt
        del base


def option_config(**backbone):
    from dsgcn_tpu_torch.configs.config import Config
    cfg = Config.fromfile(str(CONFIG))
    cfg["model"]["backbone"].update(backbone)
    return cfg


def serve_option(dev, card, out, name, cfg, per_forward, annos, calib,
                 seed):
    """A DS-GCN variant through init_recognizer / inference_recognizer
    (calibrated weights): its launches ``per_forward``, on the first
    OPTION_CPU_REQUESTS requests GPU top-1 equal to the CPU's and logits
    within 1e-3 (phase 3's criteria); then a (16, 2, 100, 25, 3) batch
    forward's ms and peak device memory."""
    from dsgcn_tpu_torch.apis import inference_recognizer, init_recognizer
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.models.recognizer import average_clip
    torch.manual_seed(seed)
    model = init_recognizer(cfg, device=dev)
    pipeline = build_pipeline(cfg["data"]["test"]["pipeline"])
    calibrate_(model, torch.from_numpy(pipeline(copy.deepcopy(calib))[
        "keypoint"]).to(dev), seed=seed)
    reset_counts()
    answers = [inference_recognizer(model, a) for a in annos]
    counts = read_counts()
    expect_counts(counts, per_forward, len(annos), f"{name} serving")
    cpu = init_recognizer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict(), strict=True)
    rows = []
    for a, ans in list(zip(annos, answers))[:OPTION_CPU_REQUESTS]:
        g, c = logits_of(model, pipeline, a), logits_of(cpu, pipeline, a)
        err = rel_err(g, c)
        cpu_top1 = int(average_clip(c[None], "prob")[0].argmax())
        check(bool(torch.isfinite(g).all()), f"{name} non-finite logits")
        check(ans[0][0] == cpu_top1,
              f"{name} GPU top-1 {ans[0]} != CPU top-1 {cpu_top1}")
        check(err <= 1e-3, f"{name} GPU logits off the CPU's by {err:.3e}")
        rows.append(dict(request=a["frame_dir"], top5=ans, cpu_top1=cpu_top1,
                         logits_rel_err=err))
    del cpu
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (OPTION_BATCH, 2, 100, V, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            y = model(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
    check(bool(torch.isfinite(y).all()), f"{name} b16 forward non-finite")
    serving = dict(requests=rows, counts=counts, b16_ms=ms,
                   b16_clips_per_s=OPTION_BATCH / ms * 1e3,
                   b16_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"{name} serving: {json.dumps(serving)} on {card}", flush=True)
    out["serving"] = serving
    return model, counts


def options(dev, card, report, batches, cpu_batch):
    """Phase 17(f, g): DS-GCN with ``target_specific`` (the per-node-type
    values) served through K3 ('auto', 10 a forward) and K1 ('fused'),
    and trained (a step against the CPU's, timed b128 steps with K1 and K2
    10 each); DS-GCN with ``ada_attention``, and with per-frame graphs
    (ctr = ada = 'NA', edge attention off: it needs T-pooled graphs), on
    the dense path with no kernel, served and trained at b16 with the peak
    device memory."""
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    annos, calib = synthetic_annos(seed=2)[:2], synthetic_annos(seed=1)[0]
    out = report.setdefault("options", {})
    ts = dict(gcn_target_specific=True)
    for ek, per in (("auto", {"bd_dyn_graph_agg": 10}),
                    ("fused", {"fused_dyn_graph_agg": 10})):
        key = f"target_specific_{ek}"
        out[key] = {}
        serve_option(dev, card, out[key], key,
                     option_config(gcn_eval_kernel=ek, **ts), per, annos,
                     calib, 17)
    k1k2 = {"fused_dyn_graph_agg": 10, "fused_dyn_graph_agg_bwd": 10}
    dense = {"ada_attention": dict(gcn_ada_attention=True),
             "NA": dict(gcn_ctr="NA", gcn_ada="NA",
                        gcn_edge_attention=False)}
    b16 = [dict(keypoint=b["keypoint"][:OPTION_BATCH],
                label=b["label"][:OPTION_BATCH]) for b in batches[:2]]
    for key, bb, per_step, steps in (
            ("target_specific", ts, k1k2, batches),
            ("ada_attention", dense["ada_attention"], {}, b16),
            ("NA", dense["NA"], {}, b16)):
        out.setdefault(key, {})
        if key != "target_specific":
            serve_option(dev, card, out[key], key, option_config(**bb), {},
                         annos, calib, 17)
        gen = torch.Generator().manual_seed(17)
        model = init_weights_(build_model(option_config(**bb)["model"]), gen)
        nudge_gates_(model, gen)
        model = model.to(dev)
        out[key]["train"] = dict(steps=[])
        gpu_vs_cpu_step(model, cpu_batch, out[key]["train"])
        timed_steps(model, steps, "f32", card, out[key]["train"], per_step)
        del model


def options_phase(dev, card, report):
    """Phase 17.  Returns the K7 errors and per-forward sums at V = 21
    (gesture) and V = 17 (STGCN++ hrnet) with their launch counts."""
    import tempfile
    from dsgcn_tpu_torch.configs.config import Config
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        g_worst, g_fwd, g_counts = gesture(dev, card, report, tmp)
        h_worst, h_fwd, h_counts = hrnet_family(dev, card, report)
        validate_by_default(tmp, report)
        eval_layouts(dev, card, report)
        train_loader, _ = train_data(tmp, Config.fromfile(str(CONFIG)),
                                     seed=17)
        batches = [as_batch(b) for b in train_loader.epoch(0)]
        cpu_batch = as_batch(next(train_loader.epoch(1)), CPU_CHECK_CLIPS)
        remat_steps(dev, card, report, batches)
        options(dev, card, report, batches, cpu_batch)
    print(f"phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(v21=(g_worst, g_fwd, g_counts, GESTURE_BATCH[0]),
                v17=(h_worst, h_fwd, h_counts, HRNET_N))


# ---------------------------------------------------------------------------
# phase 18: serving export, joint-padded mode, pyskl import
# ---------------------------------------------------------------------------

# each artifact's kernel launches a forward: the live module's main path
ARTIFACTS = {"dsgcn": {"bd_dyn_graph_agg": 10},
             "dsgcn_bf16": {"bd_dyn_graph_agg": 10},
             "dgstgcn": DG_AUTO,
             "stgcnpp_k7": {"fused_dgmstcn_eval": 10}}
SERVE_REQUESTS = 4


def per_forward(counts, forwards):
    return {k: v / forwards for k, v in counts.items() if v}


def timed_forward(fn, x, iters=5):
    """ms a forward of ``fn`` on ``x`` after two warm-up calls."""
    with torch.no_grad():
        for _ in range(2):
            fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def serve_artifacts(tmp):
    """The artifacts' side of phase 18, in a process of its own: each
    artifact through ``load_exported`` (which must import nothing of the
    port's models, configs or data), its logits on the requests' clips
    with the kernel launches around them and ``predict``'s latency per
    request; then, the models imported, each artifact's program and its
    live module (from the same checkpoint) timed in turns (live, program,
    program, live) on a (64, 2, 100, 25, 3) batch on the card, and through
    ``logits`` from the host.  Results into ``tmp/served.json``."""
    from dsgcn_tpu_torch.serving import load_exported
    print(f"card: {card_line()}", flush=True)
    tmp = pathlib.Path(tmp)
    requests = np.load(tmp / "requests.npy")
    out, served = {}, {}
    for name in ARTIFACTS:
        t0 = time.perf_counter()
        served[name] = srv = load_exported(str(tmp / name / "art"))
        load_s = time.perf_counter() - t0
        srv.logits(requests[0])
        torch.cuda.synchronize()
        reset_counts()
        logits = np.stack([srv.logits(r) for r in requests])
        torch.cuda.synchronize()
        counts = per_forward(read_counts(), len(requests))
        np.save(tmp / name / "logits.npy", logits)
        predict_ms = []
        for r in requests:
            t0 = time.perf_counter()
            scores = srv.predict(r)
            predict_ms.append((time.perf_counter() - t0) * 1e3)
        check(scores.shape == (60,) and bool(np.isfinite(scores).all()),
              f"{name}: predict gave {scores.shape} / non-finite")
        out[name] = dict(manifest=srv.manifest, load_s=load_s,
                         launches_per_forward=counts, predict_ms=predict_ms)
        print(f"artifact {name}: loaded in {load_s:.1f} s, launches a "
              f"forward {json.dumps(counts)}, predict ms "
              + ", ".join(f"{ms:.3f}" for ms in predict_ms), flush=True)
    bad = sorted(m for m in sys.modules if m.startswith((
        "dsgcn_tpu_torch.models", "dsgcn_tpu_torch.configs",
        "dsgcn_tpu_torch.data")) or m.split(".")[0] in ("jax", "dsgcn_tpu"))
    check(not bad, f"serving imported {bad}")

    from dsgcn_tpu_torch.apis import init_recognizer, to_bf16_inference
    from dsgcn_tpu_torch.core.checkpoint import CheckpointManager
    x = np.random.default_rng(3).standard_normal(THROUGHPUT_BATCH).astype(
        np.float32)
    xd = torch.from_numpy(x).cuda()
    sources = json.loads((tmp / "sources.json").read_text())
    for name, (config, work_dir, bf16) in sources.items():
        live = init_recognizer(config)
        CheckpointManager(work_dir).restore(live)
        live = to_bf16_inference(live) if bf16 else live
        program = served[name]._fns[None]
        turns = [(who, timed_forward(live if who == "live" else program, xd))
                 for who in ("live", "program", "program", "live")]
        ms = {who: float(np.mean([t for w, t in turns if w == who]))
              for who in ("live", "program")}
        ms["logits"] = timed_forward(served[name].logits, x)
        out[name]["throughput"] = {
            who: dict(ms_per_forward=t,
                      clips_per_s=THROUGHPUT_BATCH[0] / t * 1e3)
            for who, t in ms.items()}
        out[name]["turns_ms"] = turns
        if name.startswith("dsgcn"):     # the host-bound ones: busy, idle
            for who, fn in (("live", live), ("program", program)):
                breakdown(fn, xd, who, out[name], tag=f"artifact {name} ")
        print(f"artifact {name}: b64 ms a forward, in turns "
              + ", ".join(f"{w} {t:.3f}" for w, t in turns)
              + f"; through logits (host input) {ms['logits']:.3f}",
              flush=True)
        del live
    (tmp / "served.json").write_text(json.dumps(out, indent=1))


def export_config(tmp, name, base, model):
    """A config file in ``tmp`` on ``base`` whose model is replaced
    (``model``: the text of its ``model = ...`` lines)."""
    path = tmp / f"{name}.py"
    path.write_text(f"_base_ = [{str(base)!r}]\n{model}\n")
    return path


def save_checkpoint(model, work_dir):
    """The model's weights as step 0 of the port's trainer's checkpoints."""
    from dsgcn_tpu_torch.core.checkpoint import CheckpointManager
    from dsgcn_tpu_torch.core.train import make_optimizer
    opt, sched = make_optimizer(model, total_steps=1)
    CheckpointManager(str(work_dir)).save(0, model, opt, sched, epoch=0)


def live_requests(model, requests):
    """The live module's logits on the requests, and its kernel launches a
    forward."""
    reset_counts()
    with torch.inference_mode():
        logits = np.stack([model(torch.from_numpy(r).cuda()).float().cpu()
                           .numpy() for r in requests])
    torch.cuda.synchronize()
    return logits, per_forward(read_counts(), len(requests))


def padded_checks(name, model, bf16, requests, per_fwd, out):
    """``to_padded_inference(v_pad=32)`` of a live model, f32 and bf16,
    which runs at the real joints: logits on the requests against the
    model's (f32 within 1e-4, bf16 2e-3, top-1 equal) and the same
    K1/K3/K4 launches a forward."""
    from dsgcn_tpu_torch.apis import to_bf16_inference, to_padded_inference
    padded = to_padded_inference(model)
    padded_bf16 = to_bf16_inference(padded)
    row = out[name] = {}
    for tag, m, ref, tol in (("f32", padded, model, 1e-4),
                             ("bf16", padded_bf16, bf16, 2e-3)):
        want, _ = live_requests(ref, requests)
        got, counts = live_requests(m, requests)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        top1 = float((got.argmax(-1) == want.argmax(-1)).mean())
        print(f"padded {name} {tag}: logits rel err {err:.3e} against the "
              f"model, top-1 agreement {top1}, launches a forward "
              f"{json.dumps(counts)}", flush=True)
        check(err <= tol, f"padded {name} {tag} off the model by {err:.3e}")
        check(top1 == 1.0, f"padded {name} {tag} top-1 differs")
        check(counts == per_fwd, f"padded {name} {tag} launched {counts}, "
              f"the model {per_fwd}")
        row[tag] = dict(logits_rel_err=err, launches_per_forward=counts)


def pyskl_import(model, dev, requests, tmp, out):
    """A pyskl-named ``.pth`` (``torch.save`` of the calibrated DS-GCN's
    seeded arrays under pyskl's names, ``to_pyskl_state_dict``) through
    ``load_torch_checkpoint`` into full-width DS-GCN on the CPU and on the
    card: logits on two clips within 1e-3."""
    from dsgcn_tpu_torch.apis import init_recognizer
    from dsgcn_tpu_torch.utils.torch_import import (load_torch_checkpoint,
                                                    to_pyskl_state_dict)
    sd = to_pyskl_state_dict(model.state_dict())
    cpu = init_recognizer(str(CONFIG), device="cpu")
    path = tmp / "dsgcn_pyskl.pth"
    torch.save(dict(state_dict={k: torch.from_numpy(v) for k, v in sd.items()},
                    meta=dict(epoch=0)), path)
    state = load_torch_checkpoint(str(path))
    cpu.load_state_dict(state, strict=True)
    gpu = init_recognizer(str(CONFIG), device=dev)
    gpu.load_state_dict(state, strict=True)
    x = torch.from_numpy(requests[0][:2])
    with torch.inference_mode():
        want, got = cpu(x), gpu(x.to(dev)).cpu()
    err = rel_err(got, want)
    print(f"pyskl .pth ({len(sd)} arrays) into DS-GCN: GPU logits rel err "
          f"{err:.3e} against the CPU's (max |logit| "
          f"{want.abs().max().item():.3f})", flush=True)
    check(bool(torch.isfinite(got).all()) and err <= 1e-3,
          f"pyskl import: GPU logits off the CPU's by {err:.3e}")
    check(got.argmax(-1).tolist() == want.argmax(-1).tolist(),
          "pyskl import: GPU top-1 differs from the CPU's")
    out["pyskl_import"] = dict(arrays=len(sd), logits_rel_err=err)


def serving_phase(dev, card, report):
    """Phase 18: calibrated full-width DS-GCN (f32 and bf16), DG-STGCN
    ('auto') and STGCN++ (K7) exported through the port's export CLI from
    checkpoints of the port's trainer, all four at once, and served in a
    process of their own (``serve_artifacts``): dynamic batch, the live
    module's logits (f32 within 1e-5; bf16 2e-3 and top-1) and kernel
    launches a forward, clips/s beside the live module's (in turns, in the
    serving process), ``predict``'s latency, the export time; DS-GCN and
    DG-STGCN in joint-padded mode against the model; a pyskl ``.pth`` into
    DS-GCN on the card."""
    import tempfile
    from dsgcn_tpu_torch.apis import init_recognizer, to_bf16_inference
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    out = report["serving_export"] = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # the live models, as phases 3, 9 and 12 calibrate them
        torch.manual_seed(0)
        ds = init_recognizer(str(CONFIG), device=dev)
        pipeline = build_pipeline(ds.cfg["data"]["test"]["pipeline"])
        calibrate_(ds, torch.from_numpy(pipeline(synthetic_annos(seed=1)[0])[
            "keypoint"]).to(dev), seed=1)
        torch.manual_seed(1)
        dg = init_recognizer(dg_config(), device=dev)
        calibrate_(dg, torch.from_numpy(pipeline(synthetic_annos(seed=1)[0])[
            "keypoint"]).to(dev), seed=3)
        _, stg, stg_pipeline = k7_model_pair(dev, stgcnpp_config, seed=5)
        # requests of 10 clips x 2 bodies x 100 frames (STGCN++'s test
        # pipeline; the DS-GCN configs take 60): every artifact is exported
        # at T = 100, the throughput batch's
        requests = np.stack([stg_pipeline(a)["keypoint"] for a in
                             synthetic_annos(seed=2, n=SERVE_REQUESTS)])
        np.save(tmp / "requests.npy", requests)
        models = {
            "dsgcn": (ds, CONFIG, []),
            "dsgcn_bf16": (to_bf16_inference(ds), CONFIG, ["--bf16"]),
            "dgstgcn": (dg, export_config(
                tmp, "dgstgcn", CONFIG,
                "from dsgcn_tpu_torch.models.builder import model_cfg\n"
                "model = dict(model_cfg('dgstgcn'), _delete_=True)"), []),
            "stgcnpp_k7": (stg, export_config(
                tmp, "stgcnpp_k7", STGCNPP_CONFIG,
                "model = dict(backbone=dict(tcn_use_pallas=True))"), [])}
        live = {}
        for name, (m, cfg_path, flags) in models.items():
            if name != "dsgcn_bf16":
                save_checkpoint(m, tmp / name / "wd")
            logits, counts = live_requests(m, requests)
            expect_counts({k: counts.get(k, 0) for k in read_counts()},
                          ARTIFACTS[name], 1, f"live {name}")
            live[name] = logits
        (tmp / "sources.json").write_text(json.dumps({
            name: (str(cfg_path), str(tmp / name.replace("_bf16", "") / "wd"),
                   "--bf16" in flags)
            for name, (_, cfg_path, flags) in models.items()}))
        # joint-padded mode and the pyskl import, on the card alone
        out["padded"] = {}
        for name, m in (("dsgcn", ds), ("dgstgcn", dg)):
            padded_checks(name, m, to_bf16_inference(m), requests,
                          ARTIFACTS[name], out["padded"])
        pyskl_import(ds, dev, requests, tmp, out)
        # export through the CLI, the four at once
        jobs = [(["dsgcn_tpu_torch.tools.export", cfg_path, "--work-dir",
                  tmp / name.replace("_bf16", "") / "wd",
                  "--out", tmp / name / "art", "--clip-len",
                  THROUGHPUT_BATCH[2], *flags], f"export {name}")
                for name, (_, cfg_path, flags) in models.items()]
        t0 = time.perf_counter()
        stdouts = run_modules(jobs, timeout=600)
        out["export_wall_s"] = time.perf_counter() - t0
        out["export_s"] = {name: float(printed_value(s, "export_s"))
                           for name, s in zip(models, stdouts)}
        # serve in a process of its own
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--serve-artifacts", str(tmp)], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"  served: {line}", flush=True)
        check(proc.returncode == 0,
              f"serving the artifacts failed:\n{proc.stderr[-3000:]}")
        out["serve_process_s"] = time.perf_counter() - t0
        served = json.loads((tmp / "served.json").read_text())
        for name, row in served.items():
            check(row["manifest"]["polymorphic_batch"],
                  f"{name}: the artifact has no dynamic batch")
            check(row["manifest"]["device"] == "cuda",
                  f"{name}: exported for {row['manifest']['device']}")
            check(row["launches_per_forward"] == ARTIFACTS[name],
                  f"{name}: the artifact launched "
                  f"{row['launches_per_forward']} a forward, the live "
                  f"module {ARTIFACTS[name]}")
            got = np.load(tmp / name / "logits.npy")
            err = float(np.abs(got - live[name]).max()
                        / np.abs(live[name]).max())
            top1 = float((got.argmax(-1) == live[name].argmax(-1)).mean())
            print(f"artifact {name}: logits rel err {err:.3e} against the "
                  f"live module, top-1 agreement {top1}", flush=True)
            check(err <= (2e-3 if name.endswith("bf16") else 1e-5),
                  f"{name}: artifact logits off the live module's by "
                  f"{err:.3e}")
            check(top1 == 1.0, f"{name}: artifact top-1 differs")
            row.update(logits_rel_err=err, export_s=out["export_s"][name])
        out["served"] = served
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18 took {out['phase_s']:.1f} s (exports "
          f"{out['export_wall_s']:.1f} s wall, serving process "
          f"{out['serve_process_s']:.1f} s) on {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 19: data-parallel and joint-partitioned training (parallel/)
# ---------------------------------------------------------------------------

PAR_TIMED = 3            # timed DDP steps of part (a), after one warm-up
GLOO_BATCH, GLOO_STEPS = 128, 2     # part (b): the global batch, its steps
JP_BATCH = 16            # part (c)


def par_config(tmp):
    """The j config on a synthetic pickle: a train split of three b128
    batches and a val split of 129 clips (five b32 forwards)."""
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    ann = tmp / "par.pkl"
    # the first 3/4 trains: 3 batches of 128 and a few clips over
    make_synthetic_pose_dataset(num_samples=3 * TRAIN_BATCH * 4 // 3 + 4,
                                num_classes=60, t=100, seed=9, path=str(ann))
    cfg = tmp / "par_cfg.py"
    cfg.write_text(f"_base_ = [{str(CONFIG)!r}]\n"
                   f"data = dict(workers_per_gpu=8,\n"
                   f"    train=dict(ann_file={str(ann)!r}, split='train'),\n"
                   f"    val=dict(ann_file={str(ann)!r}, split='val'))\n"
                   "checkpoint_config = dict(interval=1)\n")
    return cfg


def par_cli_args(cfg, wd):
    return [str(cfg), "--work-dir", str(wd), "--validate", "--total-epochs",
            "1", "--seed", "7", "--no-auto-resume"]


def deterministic(on: bool) -> None:
    """Deterministic kernels on or off.  Three float32 steps from an
    untrained model amplify rounding (the BatchNorm stacks; PERF.md §6),
    so comparing two runs needs the same order of every sum: cuDNN's and
    the scatter-based backwards' (``torch.gather``'s) atomics otherwise
    reorder them from run to run.  The launches set CUBLAS_WORKSPACE_CONFIG
    (``PAR_ENV``) before any CUDA call."""
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def time_trainer_steps(trainer, dev):
    """ms a step of the trainer's own step function (its DDP step under a
    launcher) on one b128 batch, after one warm-up, and the peak GiB."""
    b = next(trainer.train_loader.epoch(1))
    batch = dict(keypoint=torch.from_numpy(b["keypoint"][:, 0]).to(dev),
                 label=torch.from_numpy(b["label"]).to(dev))
    trainer._step(trainer.ddp, trainer.opt, trainer.sched, batch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        trainer._step(trainer.ddp, trainer.opt, trainer.sched, batch)
    torch.cuda.synchronize(dev)
    return dict(step_ms=(time.perf_counter() - t0) / PAR_TIMED * 1e3,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)


def state_rel_err(got, want, what):
    """The largest |got - want| over max |want| of any tensor of a state;
    the three worst tensors are printed."""
    check(got.keys() == want.keys(), "the states name different tensors")
    errs = []
    for k, w in want.items():
        g = got[k].detach().float().cpu()
        w = w.detach().float().cpu()
        errs.append((((g - w).abs().max()
                      / w.abs().max().clamp_min(1e-12)).item(), k))
    errs.sort()
    print(f"{what}: worst tensors {errs[-3:]}", flush=True)
    return errs[-1][0]


def cli_part(work, tag):
    """Part (a)'s train CLI: one epoch of three b128 steps and the
    validation, deterministic (under a one-process NCCL launch: DDP; in a
    plain process: the single-device trainer); the kernels it launched, its
    weights, then (nondeterministic again) its step time and peak
    memory."""
    import torch.distributed as dist
    from dsgcn_tpu_torch.tools import train as cli
    deterministic(True)
    reset_counts()
    trainer = cli.main(par_cli_args(work / "par_cfg.py", work / f"wd_{tag}"))
    counts = read_counts()
    dev = trainer.device
    torch.save(trainer.model.state_dict(), work / f"{tag}_state.pt")
    deterministic(False)
    n_val = -(-len(trainer.val_loader.dataset)
              // trainer.val_loader.batch_size)
    launched = dist.is_initialized()
    return dict(backend=dist.get_backend() if launched else None,
                world=dist.get_world_size() if launched else None,
                device=str(dev), ddp=type(trainer.ddp).__name__,
                steps=trainer.step, val_forwards=n_val, launches=counts,
                **time_trainer_steps(trainer, dev))


def update_cosines(before, after_a, after_b):
    """Per parameter, the cosine of two updates from one state (tensors
    that neither step moved are skipped)."""
    worst = 1.0
    for k, p0 in before.items():
        da = (after_a[k].float() - p0.float()).ravel()
        db = (after_b[k].float() - p0.float()).ravel()
        if da.norm() == 0 and db.norm() == 0:
            continue
        worst = min(worst, (da @ db / (da.norm() * db.norm())).item())
    return worst


def jp_part(dev):
    """Part (c), in the same process as (a) (NCCL, world 1): DS-GCN and
    DG-STGCN with graph_axis on a (1, 1) mesh (the ring of one hop, the
    synced BatchNorms and the gathers) against the plain models (K3/K1 in
    eval, K1 + K2 in a step), b16 x M2 x T100."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.train import make_optimizer, train_step
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    from dsgcn_tpu_torch.parallel.mesh import GRAPH_AXIS, make_mesh
    make_mesh(1, 1)
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(JP_BATCH, 2, 100, V, 3, generator=gen).to(dev)
    y = torch.randint(0, 60, (JP_BATCH,), generator=gen).to(dev)
    rows = {}
    for name, mcfg in (("dsgcn", Config.fromfile(str(CONFIG))["model"]),
                       ("dgstgcn", dg_config()["model"])):
        plain = build_model(mcfg)
        init_weights_(plain, torch.Generator().manual_seed(22))
        nudge_gates_(plain, torch.Generator().manual_seed(23))
        plain = plain.to(dev).eval()
        jcfg = copy.deepcopy(mcfg)
        jcfg["backbone"]["graph_axis"] = GRAPH_AXIS
        jp = build_model(jcfg).to(dev).eval()
        jp.load_state_dict(plain.state_dict())
        reset_counts()
        with torch.no_grad():
            lp = plain(x)
            counts_plain = read_counts()
            reset_counts()
            lj = jp(x)
        counts_jp = read_counts()
        err = rel_err(lj, lp)
        row = dict(logits_rel_err=err, plain_launches=per_forward(
            counts_plain, 1), jp_launches=per_forward(counts_jp, 1),
            plain_ms=timed_forward(plain, x), jp_ms=timed_forward(jp, x))
        before = {k: v.detach().clone() for k, v in plain.state_dict().items()}
        losses, after = [], []
        for m in (plain, jp):
            opt, sched = make_optimizer(m, 10)
            losses.append(train_step(m, opt, sched, dict(
                keypoint=x, label=y))["loss"].item())
            after.append({k: v.detach() for k, v in m.state_dict().items()})
        row.update(loss_plain=losses[0], loss_jp=losses[1],
                   loss_rel_err=abs(losses[1] - losses[0]) / abs(losses[0]),
                   worst_update_cos=update_cosines(
                       {k: v for k, v in before.items() if "running" not in k
                        and "num_batches" not in k}, *after))
        rows[name] = row
        print(f"jp G=1 {name}", json.dumps(row), flush=True)
        check(err <= 1e-5, f"{name}: graph_axis logits off the plain "
              f"model's by {err:.3e}")
        check(row["loss_rel_err"] <= 1e-5 and row["worst_update_cos"] > 0.995,
              f"{name}: graph_axis step off the plain step: {row}")
        check(not any(counts_jp.values()), f"{name}: the graph_axis model "
              f"launched kernels {counts_jp}")
        del plain, jp
    return rows


def gloo_batch(step):
    """The global batch of part (b)'s step ``step`` (host numpy)."""
    rng = np.random.default_rng(100 + step)
    return (rng.standard_normal((GLOO_BATCH, 2, 60, V, 3)).astype(
        np.float32), rng.integers(0, 60, GLOO_BATCH))


def gloo_model(dev):
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    model = build_model(Config.fromfile(str(CONFIG))["model"])
    init_weights_(model, torch.Generator().manual_seed(31))
    nudge_gates_(model, torch.Generator().manual_seed(32))
    return model.to(dev)


def gloo_part(work):
    """Part (b), in each of a two-process launch: gloo, both processes on
    cuda:0, DDP of full-width DS-GCN, b64 a process, two steps
    (deterministic)."""
    import torch.distributed as dist
    from dsgcn_tpu_torch.core.train import make_optimizer
    from dsgcn_tpu_torch.parallel.mesh import (DATA_AXIS, init_distributed,
                                               make_mesh)
    from dsgcn_tpu_torch.parallel.train import distribute, make_dp_train_step
    deterministic(True)
    dev = init_distributed("gloo", device="cuda:0")
    mesh = make_mesh()
    r, half = mesh.axis(DATA_AXIS).index, GLOO_BATCH // 2
    model = gloo_model(dev)
    ddp = distribute(model, mesh, seed=31)
    opt, sched = make_optimizer(model, 10)
    step = make_dp_train_step(mesh)
    losses = []
    for s in range(GLOO_STEPS):
        kp, lab = gloo_batch(s)
        m = step(ddp, opt, sched, dict(
            keypoint=torch.from_numpy(kp[r * half:(r + 1) * half]).to(dev),
            label=torch.from_numpy(lab[r * half:(r + 1) * half]).to(dev)))
        losses.append(m["loss"].item())
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, work / f"gloo_state{r}.pt")
    return dict(backend=dist.get_backend(), world=dist.get_world_size(),
                device=str(dev), losses=losses, cuda_ops=gloo_cuda_ops(dev))


def gloo_cuda_ops(dev):
    """Which gloo collectives take CUDA tensors, of those that fail on
    both processes alike or not at all (send is ``gloo_send_probe``'s)."""
    import torch.distributed as dist
    t = torch.ones(4, device=dev)
    found = {}
    for name, op in (("all_reduce", lambda: dist.all_reduce(t)),
                     ("broadcast", lambda: dist.broadcast(t, src=0)),
                     ("all_gather", lambda: dist.all_gather(
                         [torch.empty_like(t) for _ in range(2)], t))):
        try:
            op()
            torch.cuda.synchronize(dev)
            found[name] = "ok"
        except RuntimeError as e:
            found[name] = str(e).strip().splitlines()[0][:160]
    return found


def gloo_reference(dev, work):
    """Part (b)'s steps in one process: each half of the global batch in
    train mode from the same weights and statistics, the gradients and the
    running statistics averaged by hand, then the SGD step."""
    from dsgcn_tpu_torch.core.train import loss_and_metrics, make_optimizer
    from dsgcn_tpu_torch.parallel.train import running_stats
    deterministic(True)
    model = gloo_model(dev).train()
    opt, sched = make_optimizer(model, 10)
    half, losses = GLOO_BATCH // 2, []
    stats = running_stats(model)
    for s in range(GLOO_STEPS):
        kp, lab = gloo_batch(s)
        start = [b.clone() for b in stats]
        opt.zero_grad(set_to_none=True)
        ends, step_losses = [], []
        for r in range(2):
            for b, v in zip(stats, start):
                b.copy_(v)
            loss, _ = loss_and_metrics(model, dict(
                keypoint=torch.from_numpy(kp[r * half:(r + 1) * half]),
                label=torch.from_numpy(lab[r * half:(r + 1) * half])))
            loss.backward()
            step_losses.append(loss.item())
            ends.append([b.clone() for b in stats])
        with torch.no_grad():
            for b, e0, e1 in zip(stats, *ends):
                b.copy_((e0 + e1) / 2)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad /= 2
        opt.step()
        sched.step()
        losses.append(sum(step_losses) / 2)
    return losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def gloo_send_probe(work):
    """Whether gloo sends a CUDA tensor (rank 0 to rank 1 on cuda:0): each
    process writes what it saw before the op and after it, so a process
    the op kills leaves its first line (``--parallel`` alone runs it)."""
    import datetime
    import torch.distributed as dist
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # a short timeout: an op that fails on one process only must not hold
    # the other for long
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=30))
    rank = dist.get_rank()
    t = torch.ones(4, device=dev)
    path = work / f"send{rank}.json"
    path.write_text(json.dumps({"send/recv": "started"}))
    try:
        dist.send(t, 1) if rank == 0 else dist.recv(t, 0)
        torch.cuda.synchronize(dev)
        found = "ok"
    except RuntimeError as e:
        found = str(e).strip().splitlines()[0][:160]
    path.write_text(json.dumps({"send/recv": found}))


def parallel_worker(part, work):
    """One process of a phase 19 launch (``--parallel-worker``; rank 0
    writes its report to ``work/<part>.json``) or of phase 24's expert
    parallelism (``ep``: each rank writes ``work/ep<rank>.pt``)."""
    import torch.distributed as dist
    work = pathlib.Path(work)
    if part == "single":           # a plain process: no launcher, no group
        rep = cli_part(work, "plain")
        losses, state = gloo_reference(torch.device("cuda"), work)
        torch.save(state, work / "reference_state.pt")
        rep["reference_losses"] = losses
        (work / "single.json").write_text(json.dumps(rep, default=str))
        return
    if part == "nccl":
        rep = cli_part(work, "ddp")
        rep["jp"] = jp_part(torch.device("cuda", torch.cuda.current_device()))
        (work / "nccl.json").write_text(json.dumps(rep, default=str))
    elif part == "gloo":
        rep = gloo_part(work)
        (work / f"gloo{dist.get_rank()}.json").write_text(json.dumps(rep))
    elif part == "ep":
        ep_part(work)
    else:
        gloo_send_probe(work)
    dist.destroy_process_group()


PAR_ENV = dict(CUBLAS_WORKSPACE_CONFIG=":4096:8")


def torchrun(nproc, part, work, timeout):
    """``python -m torch.distributed.run --standalone`` of ``nproc``
    processes of this script's ``part`` (``nproc`` 0: one plain process,
    no launcher); returns (rc, seconds, stderr tail).  Its process group is
    ended whatever happens."""
    import os
    import signal
    t0 = time.perf_counter()
    launcher = ([] if nproc == 0 else
                ["-m", "torch.distributed.run", "--standalone",
                 f"--nproc-per-node={nproc}"])
    proc = subprocess.Popen(
        [sys.executable, *launcher, str(ROOT / "chip_smoke.py"),
         "--parallel-worker", part, "--work", str(work)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, **PAR_ENV), start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    for line in out.splitlines():
        if line.startswith(("jp G=1", "batch:")):
            print(f"  {part}: {line}", flush=True)
    return proc.returncode, time.perf_counter() - t0, err[-3000:]


def parallel_phase(dev, card, report, send_probe=False):
    """Phase 19: (a) the train CLI under a one-process NCCL launch (DDP,
    world 1) against the plain trainer in a process of its own, same seed
    and batches, both deterministic (state within 1e-6), with 10 K1 and 10
    K2 a step and 10 K3 a validation forward; (b) DDP over gloo, two
    processes on the one card, b64 each, two steps: equal states on both,
    and equal to a reference in the plain process (each half in train
    mode, gradients and statistics averaged by hand; loss and state within
    1e-5); (c) in (a)'s process, DS-GCN and DG-STGCN with graph_axis at G
    = 1 against the plain models; and which gloo collectives take CUDA
    tensors (with ``send_probe`` also send and recv, in a launch of their
    own).  Returns the per-rank launches."""
    import tempfile
    out = report["parallel"] = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        cfg = par_config(work)
        rc, secs, err = torchrun(1, "nccl", work, 600)
        check(rc == 0, f"the NCCL launch failed ({rc}):\n{err}")
        a = json.loads((work / "nccl.json").read_text())
        print(f"(a) DDP launch: {secs:.1f} s, {json.dumps(a)}", flush=True)
        check(a["backend"] == "nccl" and a["world"] == 1
              and a["ddp"] == "DistributedDataParallel",
              f"(a) did not train under DDP over NCCL: {a}")
        per_step = {"fused_dyn_graph_agg": 10 * a["steps"],
                    "fused_dyn_graph_agg_bwd": 10 * a["steps"],
                    "bd_dyn_graph_agg": 10 * a["val_forwards"]}
        expect_counts(a["launches"], per_step, 1, "(a) the DDP epoch")
        # the plain trainer (the same CLI without a launcher) and (b)'s
        # reference, in a process of their own
        rc, secs_1, err = torchrun(0, "single", work, 600)
        check(rc == 0, f"the plain process failed ({rc}):\n{err}")
        plain = json.loads((work / "single.json").read_text())
        print(f"(a) plain process: {secs_1:.1f} s, {json.dumps(plain)}",
              flush=True)
        check(plain["ddp"] != "DistributedDataParallel",
              "the plain run trained under DDP")
        expect_counts(plain["launches"], per_step, 1, "(a) the plain epoch")
        err_a = state_rel_err(torch.load(work / "ddp_state.pt"),
                              torch.load(work / "plain_state.pt"),
                              "(a) DDP against the plain trainer")
        out["ddp_nccl"] = dict(a, state_rel_err=err_a, plain_step_ms=plain[
            "step_ms"], plain_peak_gib=plain["peak_gib"], seconds=secs)
        print(f"(a) DDP (NCCL, world 1) against the plain trainer: state "
              f"{err_a:.3e} rel; step {a['step_ms']:.2f} ms (plain "
              f"{plain['step_ms']:.2f} ms), peak {a['peak_gib']:.2f} GiB "
              f"(plain {plain['peak_gib']:.2f}) on {card}", flush=True)
        check(err_a <= 1e-6, f"(a) DDP state off the plain trainer's by "
              f"{err_a:.3e}")
        out["jp_g1"] = a["jp"]

        rc, secs, err = torchrun(2, "gloo", work, 600)
        check(rc == 0, f"the gloo launch failed ({rc}):\n{err}")
        b = [json.loads((work / f"gloo{r}.json").read_text())
             for r in range(2)]
        states = [torch.load(work / f"gloo_state{r}.pt") for r in range(2)]
        same = all(torch.equal(states[0][k], states[1][k])
                   for k in states[0])
        ref_losses = plain["reference_losses"]
        err_b = state_rel_err(states[0], torch.load(
            work / "reference_state.pt"), "(b) gloo against the reference")
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(b[0]["losses"],
                                                            ref_losses))
        out["ddp_gloo"] = dict(ranks=b, ranks_equal=same, seconds=secs,
                               reference_losses=ref_losses,
                               state_rel_err=err_b, loss_rel_err=loss_err)
        print(f"(b) DDP over gloo, 2 processes on {b[0]['device']}: ranks "
              f"equal {same}; against the in-process reference: loss "
              f"{loss_err:.3e}, state {err_b:.3e} rel ({secs:.1f} s)",
              flush=True)
        check(all(r["backend"] == "gloo" and r["world"] == 2 for r in b),
              f"(b) did not run on two gloo processes: {b}")
        check(same, "(b) the two processes end with different states")
        check(loss_err <= 1e-5 and err_b <= 1e-5,
              f"(b) off the reference: loss {loss_err:.3e}, state "
              f"{err_b:.3e}")

        ops = b[0]["cuda_ops"]
        if send_probe:
            rc, _, err = torchrun(2, "send", work, 150)
            sent = [json.loads(p.read_text()) if p.exists() else {}
                    for p in (work / f"send{r}.json" for r in range(2))]
            ops = dict(ops, send=dict(rc=rc, ranks=sent,
                                      stderr_tail=err[-600:]))
        out["gloo_cuda_ops"] = ops
        print(f"gloo collectives on CUDA tensors: {json.dumps(ops)}",
              flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    return a["launches"]


# ---------------------------------------------------------------------------
# phase 20: the author's temporal MLPs and DGHGCN in the backbones, their
# pyskl import, feature extraction through the test CLI, the host data path
# ---------------------------------------------------------------------------

K1K2 = {"fused_dyn_graph_agg": 10, "fused_dyn_graph_agg_bwd": 10}
EXTRA_STEPS = 2                           # timed steps after one warm-up


def extra_variants():
    """Phase 20's models: (name, config of the author's form, its parent
    form's config, launches a forward of each, pyskl attributes, batch).
    DS-GCN's backbone with dgmsmlp (K3 in every block); DG-STGCN with
    dghgcn; AAGCN with unit_aahgcn + unitmlp and CTRGCN with unit_ctrhgcn
    asked for msmlp (the forms of the reference's committed AAGCN_model.py
    and CTRGCN_model.py; CTRGCN takes no tcn_type, in JAX or the port, and
    keeps CTR-GCN's MSTCN); STGCN++ with msmlp and ``tcn_use_pallas``
    (the mlp branches take no K7; the parent runs 10)."""
    from dsgcn_tpu_torch.configs.config import Config

    def cfg_with(path_or_cfg, **bb):
        cfg = (Config.fromfile(str(path_or_cfg))
               if isinstance(path_or_cfg, pathlib.Path) else path_or_cfg)
        cfg["model"]["backbone"].update(bb)
        return cfg
    ctr = dict(blocks_attr="net", gcn_attr="gcn1", tcn_attr="tcn1")
    return [
        ("dsgcn_dgmsmlp", cfg_with(CONFIG, tcn_type="dgmsmlp"),
         cfg_with(CONFIG), {"bd_dyn_graph_agg": 10},
         {"bd_dyn_graph_agg": 10}, {}, "b128"),
        ("dgstgcn_dghgcn", cfg_with(dg_config(), gcn_type="dghgcn"),
         dg_config(), {}, {"fused_dyn_graph_agg": 7,
                           "bd_dyn_graph_agg_subset": 3}, {}, "b16"),
        ("aagcn_aahgcn_unitmlp",
         cfg_with(family_config("aagcn"), gcn_type="unit_aahgcn",
                  tcn_type="unitmlp", gcn_node_att=True),
         cfg_with(family_config("aagcn")), {}, {}, {}, "b16"),
        ("ctrgcn_ctrhgcn_msmlp",
         cfg_with(family_config("ctrgcn"), gcn_type="unit_ctrhgcn",
                  tcn_type="msmlp", gcn_node_attention=True,
                  gcn_edge_attention=True),
         cfg_with(family_config("ctrgcn")), {}, {}, ctr, "b16"),
        ("stgcnpp_msmlp_k7", cfg_with(stgcnpp_config(True), tcn_type="msmlp"),
         stgcnpp_config(True), {}, {"fused_dgmstcn_eval": 10}, None, "b16"),
    ]


def variant_model(cfg, dev, calib, seed):
    """The config's model, seeded (``init_weights_``, gates and units
    nudged), on ``dev``, BN statistics from ``calib``: an anno through the
    config's test pipeline, or clips (N, M, T, V, C)."""
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(build_model(cfg["model"]), gen)
    nudge_gates_(model, gen)
    nudge_units_(model, gen)
    model = model.to(dev).eval()
    pipeline = build_pipeline(cfg["data"]["test"]["pipeline"])
    if isinstance(calib, dict):
        calib = pipeline(copy.deepcopy(calib))["keypoint"]
    calibrate_(model, torch.from_numpy(calib).to(dev), seed=seed)
    return model, pipeline


def forward_ms(model, x, iters=5):
    """Wall ms of a batch forward on the card (two warm-ups) and its
    kernel launches; ``x`` is the input, or a list of a model's inputs."""
    xs = x if isinstance(x, list) else [x]
    with torch.inference_mode():
        for _ in range(2):
            y = model(*xs)
        torch.cuda.synchronize()
        reset_counts()
        y = model(*xs)
        torch.cuda.synchronize()
        counts = read_counts()
        t0 = time.perf_counter()
        for _ in range(iters):
            y = model(*xs)
        torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v).all()) for v in scores_of(y).values()),
          "a batch forward gave non-finite logits")
    return (time.perf_counter() - t0) / iters * 1e3, counts


def pyskl_round_trip(name, model, cfg, attrs, clips, tmp):
    """The model's state dict under pyskl's names (``to_pyskl_state_dict``)
    saved as a ``.pth`` and read back through ``load_torch_checkpoint``
    into the config's model on the CPU and on the card: logits on two
    clips within 1e-3, top-1 equal."""
    from dsgcn_tpu_torch.models.builder import build_model
    from dsgcn_tpu_torch.utils.torch_import import (load_torch_checkpoint,
                                                    to_pyskl_state_dict)
    sd = to_pyskl_state_dict(model.state_dict(), **attrs)
    path = tmp / f"{name}_pyskl.pth"
    torch.save(dict(state_dict={k: torch.from_numpy(v) for k, v in sd.items()},
                    meta=dict(epoch=0)), path)
    state = load_torch_checkpoint(str(path), **attrs)
    cpu, gpu = build_model(cfg["model"]), build_model(cfg["model"])
    cpu.load_state_dict(state, strict=True)
    gpu.load_state_dict(state, strict=True)
    x = clips[:2]
    with torch.inference_mode():
        want = cpu.eval()(x)
        got = gpu.cuda().eval()(x.cuda()).cpu()
    err = rel_err(got, want)
    print(f"{name}: pyskl .pth ({len(sd)} arrays) GPU logits rel err "
          f"{err:.3e} against the CPU's", flush=True)
    check(bool(torch.isfinite(got).all()) and err <= 1e-3,
          f"{name} pyskl round trip: GPU off the CPU by {err:.3e}")
    check(got.argmax(-1).tolist() == want.argmax(-1).tolist(),
          f"{name} pyskl round trip: top-1 differs")
    return dict(arrays=len(sd), logits_rel_err=err)


def step_times(model, batches, per_step, card, name, step=None):
    """One warm-up and EXTRA_STEPS timed f32 train steps (train_step, or
    ``step``): wall ms, peak GiB and each step's kernel launches
    (``per_step``, every other kernel none)."""
    from dsgcn_tpu_torch.core.train import make_optimizer, train_step
    step = step or train_step
    opt, sched = make_optimizer(model, 100)
    rows = []
    for i, b in enumerate(batches[:1 + EXTRA_STEPS]):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loss = step(model, opt, sched, b)["loss"].item()
        wall = (time.perf_counter() - t0) * 1e3
        expect_counts(read_counts(), per_step, 1, f"{name} step {i}")
        check(np.isfinite(loss), f"{name} step {i}: loss {loss}")
        rows.append(dict(step=i, warmup=i == 0, loss=loss, wall_ms=wall,
                         peak_mem_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30))
    timed = [r["wall_ms"] for r in rows[1:]]
    print(f"{name}: train steps at b{len(batches[0]['label'])} "
          f"{', '.join(f'{t:.2f}' for t in timed)} ms, peak "
          f"{rows[-1]['peak_mem_gib']:.3f} GiB, launches a step "
          f"{json.dumps(per_step)} on {card}", flush=True)
    return rows


def author_variants_part(dev, card, out, tmp):
    """Phase 20 (a)-(c): each author form serving a (64, 2, 100, 25, 3)
    batch (its launches a forward, ms beside its parent form's), GPU
    logits within 1e-3 of the CPU's on ten clips of an anno it was not
    calibrated on, top-1 equal; the pyskl round trip (not for STGCN++,
    phase 18 reads its naming); a train step against the CPU's (phase 7's
    criteria) and timed steps."""
    from dsgcn_tpu_torch.configs.config import Config
    ds_cfg = Config.fromfile(str(CONFIG))
    tmp_b = tmp / "b128"
    tmp_b.mkdir()
    train, _ = train_data(tmp_b, ds_cfg, seed=20)
    b128 = [as_batch(b) for b, _ in zip(train.epoch(0),
                                        range(1 + EXTRA_STEPS))]
    b128_cpu = as_batch(next(train.epoch(1)), CPU_CHECK_CLIPS)
    b16, b16_cpu = repeat_batches(Config.fromfile(str(family_config(
        "aagcn"))), seed=20)
    batches = dict(b128=(b128, b128_cpu), b16=(b16, b16_cpu))
    calib, anno = synthetic_annos(seed=1)[0], synthetic_annos(seed=2)[1]
    x = torch.from_numpy(np.random.default_rng(20).standard_normal(
        THROUGHPUT_BATCH).astype(np.float32)).to(dev)
    for i, (name, cfg, parent_cfg, per_fwd, parent_fwd, attrs, kind) in \
            enumerate(extra_variants()):
        row = out[name] = {}
        model, pipeline = variant_model(cfg, dev, calib, seed=20 + i)
        cpu = copy.deepcopy(model).cpu()
        g, c = logits_of(model, pipeline, anno), logits_of(cpu, pipeline,
                                                            anno)
        err = rel_err(g, c)
        top1 = g.argmax(-1).tolist() == c.argmax(-1).tolist()
        check(bool(torch.isfinite(g).all()) and err <= 1e-3 and top1,
              f"{name}: GPU logits off the CPU's by {err:.3e} (top-1 equal "
              f"{top1})")
        ms, counts = forward_ms(model, x)
        expect_counts(counts, per_fwd, 1, f"{name} b64 forward")
        parent, _ = variant_model(parent_cfg, dev, calib, seed=20 + i)
        parent_ms, parent_counts = forward_ms(parent, x)
        expect_counts(parent_counts, parent_fwd, 1, f"{name}'s parent form")
        del parent
        row.update(logits_rel_err=err, top1_equal=top1, ms=ms,
                   clips_per_s=THROUGHPUT_BATCH[0] / ms * 1e3,
                   launches=counts, parent_ms=parent_ms,
                   parent_clips_per_s=THROUGHPUT_BATCH[0] / parent_ms * 1e3,
                   parent_launches=parent_counts)
        print(f"{name}: b64 forward {ms:.3f} ms ({row['clips_per_s']:.1f} "
              f"clips/s; launches {json.dumps(counts)}), parent form "
              f"{parent_ms:.3f} ms ({row['parent_clips_per_s']:.1f} clips/s; "
              f"{json.dumps(parent_counts)}); GPU vs CPU logits {err:.3e} "
              f"on {card}", flush=True)
        if attrs is not None:
            clips = torch.from_numpy(pipeline(copy.deepcopy(anno))[
                "keypoint"])
            row["pyskl"] = pyskl_round_trip(name, model, cfg, attrs, clips,
                                            tmp)
        steps, cpu_batch = batches[kind]
        row["train"] = {}
        gpu_vs_cpu_step(model, cpu_batch, row["train"])
        row["train"]["steps"] = step_times(
            model, steps, K1K2 if kind == "b128" else {}, card, name)
        del model, cpu
        torch.cuda.empty_cache()


def float32_features(cfg, x, wd, dev, card):
    """The checkpoint's unpooled float32 features (``extract_pooled_feat``,
    pool 'none') of the folded test clips ``x``, on the card against the
    CPU: within 1e-3 of the largest."""
    from dsgcn_tpu_torch.apis import init_recognizer
    from dsgcn_tpu_torch.models.recognizer import extract_pooled_feat
    ckpt = str(next((wd / "ckpt").glob("*.pt")))
    feats = [extract_pooled_feat(init_recognizer(cfg, ckpt, device=d),
                                 x.to(d), "none").cpu()
             for d in (dev, "cpu")]
    err = rel_err(*feats)
    print(f"float32 features {tuple(feats[0].shape)}: card against CPU "
          f"{err:.3e} of the largest on {card}", flush=True)
    check(bool(torch.isfinite(feats[0]).all()) and err <= 1e-3,
          f"float32 features off the CPU's by {err:.3e}")
    return dict(shape=list(feats[0].shape), rel_err=err)


def feature_cli_part(dev, card, out, tmp):
    """Phase 20 (d): calibrated full-width DS-GCN (the j config) saved as a
    checkpoint of the port's trainer, its test split (four synthetic
    videos, ten clips each, one batch) through the test CLI in this
    process: ``--feat-ext --pool-opt all``, ``--pool-opt tv`` and
    ``--score-ext`` on the card (10 K3 launches a backbone forward, the
    TSNEmap on the card) against the same CLI with ``--device cpu``
    (float16 dumps within 1e-3 of the largest feature plus one float16
    step at each value, since each side rounds to float16 on its own);
    the float32 features of ``extract_pooled_feat`` (pool 'none') on the
    same batch, the card against the CPU, within 1e-3; then the scores
    with ``confusion_matrix`` and their mAP against one-hot labels; and a
    t-SNE of 1000 points on the card."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.metrics import evaluate
    from dsgcn_tpu_torch.data.dataset import (Loader, build_dataset,
                                              make_synthetic_pose_dataset)
    from dsgcn_tpu_torch.tools import test as test_cli
    from dsgcn_tpu_torch.utils.analysis import tsne_map
    ann = tmp / "feat.pkl"
    make_synthetic_pose_dataset(num_samples=16, num_classes=60, t=100,
                                seed=21, path=str(ann))
    cfg_path = tmp / "feat_cfg.py"
    cfg_path.write_text(
        f"_base_ = [{str(CONFIG)!r}]\n"
        "data = dict(workers_per_gpu=4, test_dataloader=dict("
        "videos_per_gpu=4),\n"
        f"    test=dict(ann_file={str(ann)!r}, split='val'))\n")
    cfg = Config.fromfile(str(cfg_path))
    kp = next(Loader(build_dataset(cfg["data"]["test"], test_mode=True),
                     batch_size=4, shuffle=False,
                     num_workers=4).epoch(0))["keypoint"]
    x = kp.reshape((-1,) + kp.shape[2:])          # the test clips, folded
    # BN statistics from the clips the model extracts features of: from
    # other data, activations reach 1e3 and rounding grows through the
    # blocks
    model, _ = variant_model(cfg, dev, x, seed=21)
    wd = tmp / "feat_wd"
    save_checkpoint(model, wd)
    del model
    common = [str(cfg_path), str(wd), "--metrics", "TSNEmap", "graph"]
    rows = {}
    for tag, flags in (("feat_all", ["--feat-ext", "--pool-opt", "all"]),
                       ("feat_tv", ["--feat-ext", "--pool-opt", "tv"]),
                       ("score_ext", ["--score-ext"])):
        reset_counts()
        t0 = time.perf_counter()
        got, labels = test_cli.main(common + flags + ["--out", str(
            tmp / f"{tag}.pkl")])
        secs = time.perf_counter() - t0
        counts = read_counts()
        want, want_labels = test_cli.main(common[:2] + flags
                                          + ["--device", "cpu"])
        g32, w32 = got.astype(np.float32), want.astype(np.float32)
        diff = np.abs(g32 - w32)
        err = float(diff.max() / np.abs(w32).max())
        over = float((diff - 1e-3 * np.abs(w32).max()
                      - np.spacing(np.abs(want))).max())
        dump = load_pickle(tmp / f"{tag}.pkl")
        print(f"test CLI {' '.join(flags)}: features {got.shape} "
              f"{got.dtype}, rel err {err:.3e} against --device cpu (past "
              f"1e-3 plus one float16 step: {over:.3e}), launches "
              f"{json.dumps(counts)}, {secs:.2f} s on {card}", flush=True)
        check(got.dtype == np.float16 and bool(np.isfinite(got).all())
              and got.shape == want.shape, f"{tag}: features {got.shape}")
        check(over <= 0, f"{tag}: GPU features off the CPU's by {err:.3e}")
        check(labels == want_labels == dump["labels"], f"{tag}: labels")
        check(np.array_equal(dump["features"], got), f"{tag}: the dump")
        expect_counts(counts, {"bd_dyn_graph_agg": 10}, 1,
                      f"{tag}: one backbone forward")
        rows[tag] = dict(shape=list(got.shape), rel_err=err, seconds=secs,
                         launches=counts)
    rows["float32"] = float32_features(cfg, torch.from_numpy(x), wd, dev,
                                       card)
    reset_counts()
    scores, labels = test_cli.main(common[:2] + [
        "--metrics", "top_k_accuracy", "confusion_matrix"])
    expect_counts(read_counts(), {"bd_dyn_graph_agg": 10}, 1, "scores")
    onehot = np.eye(scores.shape[1], dtype=int)[labels]
    res = evaluate(scores, onehot, ["mean_average_precision"])
    res.update(evaluate(scores, labels, ["confusion_matrix"]))
    check(np.isfinite(res["mean_average_precision"])
          and res["confusion_matrix"].ndim == 2, f"scores' metrics {res}")
    rows["scores"] = dict(mean_average_precision=res[
        "mean_average_precision"], confusion_matrix=np.shape(res[
            "confusion_matrix"]))
    pts = np.random.default_rng(22).standard_normal((1000, 32))
    pts[:500] += 4.0
    t0 = time.perf_counter()
    emb = tsne_map(pts)
    tsne_s = time.perf_counter() - t0
    d = ((emb[:, None] - emb[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nn_same = float(((d.argmin(1) < 500) == (np.arange(1000) < 500)).mean())
    print(f"tsne_map of 1000 points (32 features) on the card: "
          f"{tsne_s:.2f} s, nearest neighbour in its own cluster "
          f"{nn_same:.4f} on {card}", flush=True)
    check(emb.shape == (1000, 2) and bool(np.isfinite(emb).all())
          and nn_same > 0.99, f"t-SNE on the card: {nn_same}")
    rows["tsne_1000"] = dict(seconds=tsne_s, nn_same_cluster=nn_same)
    out["feature_cli"] = rows


def host_data_part(card, out, tmp):
    """Phase 20 (e): the NTU j train pipeline with the native
    PreNormalize3D (``use_native=True``, the default) and the numpy path on
    64 synthetic annos from the same RandomStates: clips within 1e-6 of
    the largest, ms per clip of each; one class_prob epoch of the Loader
    (its length the replicated count)."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.data.dataset import (Loader, PoseDataset,
                                              epoch_indices,
                                              make_synthetic_pose_dataset)
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    pipe = Config.fromfile(str(CONFIG))["data"]["train"]["pipeline"]
    check(pipe[0]["type"] == "PreNormalize3D", "no PreNormalize3D first")
    path = str(tmp / "host.pkl")
    annos = make_synthetic_pose_dataset(num_samples=64, num_classes=60,
                                        t=100, seed=23,
                                        path=path)["annotations"]
    clips, ms = {}, {}
    for native in (True, False):
        p = copy.deepcopy(pipe)
        p[0]["use_native"] = native
        pipeline = build_pipeline(p)
        pipeline(copy.deepcopy(annos[0]), rng=np.random.RandomState(0))
        t0 = time.perf_counter()
        clips[native] = [pipeline(copy.deepcopy(a),
                                  rng=np.random.RandomState(i))["keypoint"]
                         for i, a in enumerate(annos)]
        ms[native] = (time.perf_counter() - t0) * 1e3 / len(annos)
    err = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(clips[True], clips[False]))
    print(f"NTU j train pipeline: native PreNormalize3D {ms[True]:.3f} ms "
          f"per clip, numpy {ms[False]:.3f} ms ({ms[False] / ms[True]:.2f}x);"
          f" clips rel err {err:.3e} (host of {card})", flush=True)
    check(err <= 1e-6, f"native pipeline off the numpy one by {err:.3e}")
    prob = {i: (2.0 if i % 2 else 0.5) for i in range(60)}
    loader = Loader(PoseDataset(path, pipe, split="train"), batch_size=16,
                    seed=23, num_workers=8, class_prob=prob)
    want = len(epoch_indices(len(loader.dataset), 0, seed=23,
                             class_prob=prob, labels=loader.dataset.labels))
    t0 = time.perf_counter()
    seen = sum(len(b["label"]) for b in loader.epoch(0))
    secs = time.perf_counter() - t0
    print(f"class_prob loader: {seen} clips in an epoch of "
          f"{len(loader.dataset)} samples ({secs:.2f} s)", flush=True)
    check(seen == want and seen != len(loader.dataset),
          f"class_prob epoch of {seen} clips, expected {want}")
    out["host_data"] = dict(native_ms_per_clip=ms[True],
                            numpy_ms_per_clip=ms[False], rel_err=err,
                            class_prob_epoch=seen,
                            dataset=len(loader.dataset))


def extras_phase(dev, card, report):
    """Phase 20: the author's variants (a-c), feature extraction through
    the test CLI (d) and the host data path (e)."""
    import tempfile
    out = report["extras"] = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        author_variants_part(dev, card, out, tmp)
        feature_cli_part(dev, card, out, tmp)
        host_data_part(card, out, tmp)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20: {out['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 21: the other GCN families (MS-G3D, SGN, GTGCN, STGIN, STGCN_GC) and
# the Granger-causality learners (GCGCN, GCGCN_component with GCHead)
# ---------------------------------------------------------------------------

OTHER_CPU_CLIPS = 2                 # clips of each family's CPU checks
# STGIN's train batch: b16 x M2 x T100 keeps ~5 GB of edge tensors a block
STGIN_TRAIN_BATCH = 16


class ExternalGraph(torch.nn.Module):
    """STGCN_GC fed a fixed external (K, V, V) graph, then its GCNHead: the
    composition a user writes by hand (a RecognizerGCN feeds its backbone
    the clip alone)."""

    def __init__(self, backbone, head, A_ext):
        super().__init__()
        self.backbone, self.head = backbone, head
        self.register_buffer("A_ext", A_ext)

    def forward(self, x):
        return self.head(self.backbone(x, self.A_ext))


class GrangerRecognizer(torch.nn.Module):
    """A Granger-causality learner and a GCHead over the graph it learns;
    ``loss`` is the GC objective (``core/flows.py:gc_recognizer_losses``)."""

    def __init__(self, backbone, head):
        super().__init__()
        self.backbone, self.head = backbone, head

    @staticmethod
    def graph(out):
        return out[0] if len(out) == 4 else out[1]

    def forward(self, x):
        return self.head(self.graph(self.backbone(x)))

    def loss(self, x, label):
        from dsgcn_tpu_torch.core.flows import gc_recognizer_losses
        out = self.backbone(x)
        return gc_recognizer_losses(out, self.head(self.graph(out)), label)


class fixed_dropout_masks:
    """SGN's dropout with one mask per shape, drawn on the host from a
    seeded CPU generator at each call, so that the card and the CPU step
    with the same mask (phase 7's check of one step against the other);
    the module draws its masks from the device's generator, whose streams
    differ between the card and the CPU."""

    def __enter__(self):
        from dsgcn_tpu_torch.models import msg3d_sgn
        self.module, self.dropout = msg3d_sgn, msg3d_sgn.dropout

        def fixed(x, p, training, generator=None):
            if not training or p <= 0:
                return x
            keep = torch.empty(x.shape).bernoulli_(
                1 - p, generator=torch.Generator().manual_seed(21))
            return x * (keep / (1 - p)).to(x.device, x.dtype)
        msg3d_sgn.dropout = fixed

    def __exit__(self, *exc):
        self.module.dropout = self.dropout


def gc_train_step(model, opt, sched, batch):
    """``core/train.py:train_step`` with the GC objective in place of the
    cross entropy (a Granger recognizer's step, Recognizergcn_gc.py)."""
    from dsgcn_tpu_torch.core.train import zero_missing_grads_
    model.train()
    dev = next(model.parameters()).device
    kp = torch.as_tensor(batch["keypoint"]).to(dev)
    label = torch.as_tensor(batch["label"]).to(dev)
    loss, _ = model.loss(kp, label)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    zero_missing_grads_(opt)
    opt.step()
    sched.step()
    return dict(loss=loss.detach())


def other_config(name):
    """The STGCN++ j config (NTU, its pipelines, b16 x T100) with its model
    replaced: ``model_cfg('msg3d'|'sgn')`` or a full-width GTGCN / STGIN
    recognizer (each family's defaults); the test pipeline at
    OTHER_CPU_CLIPS clips, SGN's pipelines at its 30 frames."""
    from dsgcn_tpu_torch.models.builder import model_cfg
    cfg = stgcnpp_config(False)
    if name in ("msg3d", "sgn"):
        cfg["model"] = model_cfg(name)
    else:
        cfg["model"] = dict(type="RecognizerGCN", backbone=dict(
            type=name.upper(), graph_cfg=dict(layout="nturgb+d",
                                              mode="spatial")),
            cls_head=dict(type="GCNHead", num_classes=60, in_channels=256))
    for pipe in (cfg["data"]["train"]["dataset"]["pipeline"],
                 cfg["data"]["test"]["pipeline"]):
        for step in pipe:
            if step["type"] == "UniformSample":
                if "num_clips" in step:
                    step["num_clips"] = OTHER_CPU_CLIPS
                if name == "sgn":
                    step["clip_len"] = 30
    return cfg


def other_model(name, seed):
    """A phase 21 model on the CPU, seeded (``init_weights_``, gates
    nudged): STGCN_GC as :class:`ExternalGraph` with a seeded graph (NTU's
    spatial subsets plus U(0, 0.05)) and ``gcn_adaptive='importance'``;
    the learners as :class:`GrangerRecognizer` with a GCHead (625 -> 60,
    dropout 0 so that the card and the CPU draw no masks)."""
    from dsgcn_tpu_torch.graph import Graph
    from dsgcn_tpu_torch.models.builder import (build_backbone, build_head,
                                                build_model, init_weights_)
    gen = torch.Generator().manual_seed(seed)
    if name == "stgcn_gc":
        A = torch.from_numpy(Graph(layout="nturgb+d", mode="spatial").A
                             .astype(np.float32))
        model = ExternalGraph(
            build_backbone(dict(type="STGCN_GC", gcn_adaptive="importance",
                                graph_cfg=dict(layout="nturgb+d",
                                               mode="spatial"))),
            build_head(dict(type="GCNHead", num_classes=60,
                            in_channels=256)),
            A + 0.05 * torch.rand(A.shape, generator=gen))
    elif name in ("gcgcn", "gcgcn_component"):
        model = GrangerRecognizer(
            build_backbone(dict(type="GCGCN" if name == "gcgcn"
                                else "GCGCN_component")),
            build_head(dict(type="GCHead", num_classes=60,
                            in_channels=25 * 25, dropout=0.0)))
    else:
        model = build_model(other_config(name)["model"])
    init_weights_(model, gen)
    nudge_gates_(model, gen)
    nudge_pre_bn_biases_(model, gen)
    return model


def nudge_pre_bn_biases_(model, gen):
    """The biases that feed a train-mode BatchNorm (an ``<x>_conv`` beside
    an ``<x>_bn``, MS-G3D's ``out_conv_bias`` before its ``out_bn``) get a
    gradient of rounding noise (MS-G3D's window biases start at zero, where
    that noise is all of their update).  At U(1, 2) their first update is
    the weight decay's, the same on the card and the CPU, and phase 7's
    update check reads the gradients that exist; the function is unchanged
    (the BatchNorm takes the shift out)."""
    with torch.no_grad():
        for m in model.modules():
            for cname, child in m.named_children():
                bias = getattr(child, "bias", None)
                if cname.endswith("_conv") and bias is not None \
                        and hasattr(m, cname[:-len("conv")] + "bn"):
                    bias.uniform_(1, 2, generator=gen)
            if hasattr(m, "out_conv_bias"):
                m.out_conv_bias.uniform_(1, 2, generator=gen)


def serve_entry_points(name, model, dev, out):
    """MS-G3D and SGN through the entry points: a checkpoint of the seeded
    model read by ``init_recognizer`` on the card, BN statistics from data,
    two requests through ``inference_recognizer`` (each request's ms); the
    GPU's top-1 equal to the CPU's and its logits within 1e-3 of them on
    the requests' clips."""
    import tempfile
    from dsgcn_tpu_torch.apis import inference_recognizer, init_recognizer
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.models.recognizer import average_clip
    cfg = other_config(name)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = pathlib.Path(tmp) / f"{name}.pt"
        torch.save(model.state_dict(), ckpt)
        gpu = init_recognizer(cfg, checkpoint=str(ckpt), device=dev)
    pipeline = build_pipeline(cfg["data"]["test"]["pipeline"])
    calibrate_(gpu, torch.from_numpy(pipeline(copy.deepcopy(
        synthetic_annos(seed=1)[0]))["keypoint"]).to(dev), seed=21)
    rows, request_ms = [], []
    cpu = copy.deepcopy(gpu).cpu()
    for a in synthetic_annos(seed=2, n=2):
        t0 = time.perf_counter()
        with torch.inference_mode():
            ans = inference_recognizer(gpu, a)
        request_ms.append((time.perf_counter() - t0) * 1e3)
        g, c = logits_of(gpu, pipeline, a), logits_of(cpu, pipeline, a)
        err = rel_err(g, c)
        check(g.shape == (OTHER_CPU_CLIPS, 60)
              and bool(torch.isfinite(g).all()),
              f"{name} logits of shape {tuple(g.shape)} or not finite")
        cpu_top1 = int(average_clip(c[None], "prob")[0].argmax())
        check(ans[0][0] == cpu_top1 and err <= 1e-3,
              f"{name} request {a['frame_dir']}: GPU top-1 {ans[0][0]} vs "
              f"CPU {cpu_top1}, logits rel err {err:.3e}")
        rows.append(dict(request=a["frame_dir"], top5=ans,
                         cpu_top1=cpu_top1, logits_rel_err=err))
    out["requests"], out["request_ms"] = rows, request_ms
    print(f"{name}: requests through init_recognizer / inference_recognizer "
          f"({OTHER_CPU_CLIPS} clips): ms " + ", ".join(
              f"{ms:.3f}" for ms in request_ms) + "; logits rel err "
          + ", ".join(f"{r['logits_rel_err']:.3e}" for r in rows),
          flush=True)
    return gpu


def no_launches(what):
    """No kernel of the port launched since the counts were last set to
    0 (by the phase, ``forward_ms`` or ``step_times``)."""
    expect_counts(read_counts(), {}, 1, what)


def other_families(dev, card, report):
    """Phase 21: each family at full width, seeded, BN statistics from data
    (``calibrate_``): MS-G3D and SGN served through the entry points; every
    model's GPU logits against the CPU's on OTHER_CPU_CLIPS clips (top-1
    equal, 1e-3); a (64, 2, T, 25, 3) batch forward (T = 30 for SGN, 100
    otherwise; MS-G3D and SGN in f32 and bf16 through
    ``to_bf16_inference``) with its ms, busy and idle time, top device ops
    and peak memory; a train step against the CPU's (phase 7's criteria;
    the learners on the GC objective and in float64; OTHER_CPU_CLIPS
    clips) and timed f32 steps at b16 x M2 x T100
    (SGN T30; STGIN at STGIN_TRAIN_BATCH) with their peak memory.  No
    kernel of the port may launch anywhere in the phase."""
    from dsgcn_tpu_torch.apis import to_bf16_inference
    out_all = report["other_families"] = {}
    t_phase = time.perf_counter()
    reset_counts()
    names = ("msg3d", "sgn", "gtgcn", "stgin", "stgcn_gc", "gcgcn",
             "gcgcn_component")
    base_batches, base_cpu = repeat_batches(other_config("gtgcn"), seed=21)
    sgn_batches, sgn_cpu = repeat_batches(other_config("sgn"), seed=21)
    calib = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (8, 2, 100, 25, 3)).astype(np.float32))
    for i, name in enumerate(names):
        t_fam = time.perf_counter()
        out = out_all[name] = {}
        t_len = 30 if name == "sgn" else 100
        model = other_model(name, seed=21 + i).to(dev).eval()
        if name in ("msg3d", "sgn"):
            model = serve_entry_points(name, model, dev, out)
        else:
            calibrate_(model, calib.to(dev), seed=21 + i)
        x = torch.from_numpy(np.random.default_rng(22).standard_normal(
            (64, 2, t_len, 25, 3)).astype(np.float32)).to(dev)
        cpu = copy.deepcopy(model).cpu()
        with torch.inference_mode():
            g = model(x[:OTHER_CPU_CLIPS]).cpu()
            c = cpu(x[:OTHER_CPU_CLIPS].cpu())
        err = rel_err(g, c)
        top1 = g.argmax(-1).tolist() == c.argmax(-1).tolist()
        print(f"{name}: GPU vs CPU logits rel err {err:.3e} on "
              f"{OTHER_CPU_CLIPS} clips, top-1 equal {top1}", flush=True)
        check(bool(torch.isfinite(g).all()) and err <= 1e-3 and top1,
              f"{name}: GPU logits off the CPU's by {err:.3e} (top-1 equal "
              f"{top1})")
        out.update(logits_rel_err=err, top1_equal=top1)
        no_launches(f"{name} serving")
        torch.cuda.reset_peak_memory_stats()
        if name in ("msg3d", "sgn"):
            throughput(model, to_bf16_inference(model), dev, card, out,
                       f"{name} ", tuple(x.shape), 60)
            no_launches(f"{name} batch forwards")
        else:
            ms, counts = forward_ms(model, x)
            expect_counts(counts, {}, 1, f"{name} batch forward")
            out["throughput"] = {"f32": dict(
                ms_per_forward=ms, clips_per_s=x.shape[0] / ms * 1e3)}
            print(f"throughput {name} f32: batch {tuple(x.shape)} "
                  f"{ms:.3f} ms/forward, {x.shape[0] / ms * 1e3:.1f} "
                  f"clips/s on {card}", flush=True)
            breakdown(model, x, "f32", out, f"{name} ")
            no_launches(f"{name} profiled forward")
        out["forward_peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
        print(f"{name}: forward peak {out['forward_peak_mem_gib']:.3f} GiB",
              flush=True)
        del x, cpu
        step = gc_train_step if isinstance(model, GrangerRecognizer) \
            else None
        batches, cpu_batch = ((sgn_batches, sgn_cpu) if name == "sgn"
                              else (base_batches, base_cpu))
        cpu_batch = {k: v[:OTHER_CPU_CLIPS] for k, v in cpu_batch.items()}
        if name == "stgin":
            batches = [dict(keypoint=b["keypoint"][:STGIN_TRAIN_BATCH],
                            label=b["label"][:STGIN_TRAIN_BATCH])
                       for b in batches]
        out["train"] = {}
        with fixed_dropout_masks():
            if step is gc_train_step:
                # the Granger objective (~1.5e3, its GSGL penalty) makes the
                # float32 gradient of a bias before a BatchNorm (exactly
                # zero) rounding noise as large as its weight decay, over
                # the four rows of the causal chain's BatchNorm: the card's
                # step is held to the CPU's in float64
                gpu_vs_cpu_step(copy.deepcopy(model).double(), dict(
                    keypoint=cpu_batch["keypoint"].astype(np.float64),
                    label=cpu_batch["label"]), out["train"], step)
            else:
                gpu_vs_cpu_step(model, cpu_batch, out["train"], step)
        no_launches(f"{name} GPU vs CPU step")
        out["train"]["steps"] = step_times(model, batches, {}, card, name,
                                           step)
        out["seconds"] = time.perf_counter() - t_fam
        del model
        torch.cuda.empty_cache()
    counts = read_counts()
    expect_counts(counts, {}, 1, "phase 21's forwards and steps")
    out_all["launches"] = counts
    out_all["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21: every forward and step of MS-G3D, SGN, GTGCN, STGIN, "
          f"STGCN_GC, GCGCN and GCGCN_component launched no kernel of the "
          f"port: {json.dumps(counts)}; {out_all['seconds']:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 22: PoseC3D, SlowOnly-R50 over heatmap volumes (no kernel)
# ---------------------------------------------------------------------------

POSEC3D_CONFIG = ROOT / "configs" / "posec3d" / "slowonly_ntu60_xsub.py"
POSEC3D_BATCH = 32                  # the config's videos_per_gpu
POSEC3D_STEPS = 5                   # timed steps after one warm-up
POSEC3D_CPU_CLIPS = 2               # clips of the step against the CPU
POSEC3D_VIDEOS = 4                  # test videos served on the card
POSEC3D_CPU_VIDEOS = 2              # of them, scored on the CPU too
POSEC3D_CPU_LOGIT_CLIPS = (0, 1, 10, 11)   # two clips of each served video


def posec3d_annos(tmp, n_train, n_test, seed):
    """Synthetic hrnet annos (COCO, 17 joints, 100 frames, 60 classes) in
    a pickle whose 'train' split holds ``n_train`` and 'val' ``n_test``,
    and 'cpu' the first POSEC3D_CPU_VIDEOS of the val ones."""
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    data = make_synthetic_pose_dataset(num_samples=n_train + n_test,
                                       num_classes=60, t=100, seed=seed,
                                       layout="coco")
    names = [a["frame_dir"] for a in data["annotations"]]
    data["split"] = dict(train=names[:n_train], val=names[n_train:],
                         cpu=names[n_train:n_train + POSEC3D_CPU_VIDEOS])
    path = tmp / "posec3d.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def posec3d_cli_config(tmp, ann, split, model=None, tag="posec3d"):
    """The committed config reading ``ann``: train on its 'train' split,
    validate on 'cpu', test on ``split``, two videos a test batch; with
    ``model`` that model config in place of the committed one."""
    path = tmp / f"{tag}_{split}.py"
    path.write_text(
        f"_base_ = ['{POSEC3D_CONFIG}']\n"
        + ("" if model is None else
           f"model = {dict(model, _delete_=True)!r}\n")
        + "data = dict(test_dataloader=dict(videos_per_gpu=2),\n"
        f"            train=dict(ann_file='{ann}', split='train'),\n"
        f"            val=dict(ann_file='{ann}', split='cpu'),\n"
        f"            test=dict(ann_file='{ann}', split='{split}'))\n")
    return path


def posec3d_train_cli(tmp, ann, out, model=None, tag="posec3d"):
    """The train CLI on the committed config (with ``model`` in place of
    its model) for one epoch of its 'train' split (two b32 steps) on the
    card: the trainer's ``imgs`` batches, a validation of the 'cpu'
    split's 10-clip videos, a checkpoint; the seconds it took."""
    from dsgcn_tpu_torch.tools import train as train_cli
    wd = tmp / f"wd_train_{tag}"
    t0 = time.perf_counter()
    trainer = train_cli.main([str(posec3d_cli_config(tmp, ann, "val", model,
                                                     tag)),
                              "--work-dir", str(wd), "--total-epochs", "1",
                              "--no-auto-resume"])
    secs = time.perf_counter() - t0
    logs = [json.loads(line) for f in wd.glob("*.log.jsonl")
            for line in f.read_text().splitlines()]
    val = [r for r in logs if r.get("mode") == "val"]
    check(trainer.step == 2 and len(val) == 1
          and any(wd.glob("ckpt/*.pt")),
          f"posec3d train CLI: {trainer.step} steps, {len(val)} val "
          f"records, checkpoints {sorted(wd.glob('ckpt/*'))}")
    out["train_cli"] = dict(seconds=secs, steps=trainer.step, val=val[0])
    print(f"{tag}: train CLI, one epoch of 2 b32 steps and a 2-video "
          f"validation, {secs:.2f} s: val {json.dumps(val[0])}", flush=True)
    del trainer
    torch.cuda.empty_cache()


def calibrate_posec3d_(model, *xs):
    """BatchNorm statistics from the inputs ``xs`` in one train-mode
    forward: from the seeded statistics (mean 0, variance 1) momentum 0.1
    leaves each running statistic 0.1 of the batch's (the unbiased
    variance) plus 0.9 of the seed's, which this undoes; the model goes
    back to eval."""
    from dsgcn_tpu_torch.ops.common import BNStats
    bns = [m for m in model.modules()
           if isinstance(m, BNStats) and hasattr(m, "running_mean")]
    check(len(bns) > 0 and all(bool((m.running_mean == 0).all()
                                     and (m.running_var == 1).all())
                               for m in bns),
          "calibrate_posec3d_ needs the seeded BatchNorm statistics")
    model.train()
    with torch.no_grad():
        model(*xs)
        for m in bns:
            m.running_mean.div_(0.1)
            m.running_var.sub_(0.9).div_(0.1)
    model.eval()


def posec3d_logits_check(model, clips, card, out):
    """The served model's logits on ``clips`` (two videos' 10 clips each)
    on the card, against a CPU copy's on two clips of each video: within
    1e-3 of the largest CPU logit.  So that the comparison can tell one
    clip's or class's logits from another's, the card's logits must vary
    across clips (the mean over classes of their standard deviation over
    the clips) and across classes (the mean over clips of their standard
    deviation over the classes) by at least 1e-2 of the largest, ten times
    the tolerance."""
    idx = torch.tensor(POSEC3D_CPU_LOGIT_CLIPS)
    with torch.inference_mode():
        g = model(clips).float().cpu()
        c = copy.deepcopy(model).cpu()(clips[idx].cpu()).float()
    check(g.shape == (clips.shape[0], 60) and bool(torch.isfinite(g).all()),
          f"posec3d logits of shape {tuple(g.shape)} or not finite")
    err = rel_err(g[idx], c)
    top = g.abs().max()
    over_clips = (g.std(dim=0).mean() / top).item()
    over_classes = (g.std(dim=1).mean() / top).item()
    out["logits"] = dict(rel_err=err, largest=top.item(),
                         spread_over_clips=over_clips,
                         spread_over_classes=over_classes,
                         cpu_clips=POSEC3D_CPU_LOGIT_CLIPS)
    print(f"posec3d: logits of {tuple(g.shape)} clips, card against CPU on "
          f"clips {POSEC3D_CPU_LOGIT_CLIPS}: {err:.3e} of the largest "
          f"({top.item():.4g}); spread over clips {over_clips:.3e}, over "
          f"classes {over_classes:.3e} of the largest, on {card}",
          flush=True)
    check(err <= 1e-3, f"posec3d: GPU logits off the CPU's by {err:.3e} of "
          f"the largest")
    check(over_clips >= 1e-2 and over_classes >= 1e-2,
          f"posec3d: logits spread {over_clips:.3e} over clips and "
          f"{over_classes:.3e} over classes of the largest, under 1e-2: "
          f"the comparison would not tell them apart")


def posec3d_test_cli(tmp, ann, wd, card, out):
    """The test CLI with the config's averaging (prob) on the checkpoint
    under ``wd``: the 'val' split's POSEC3D_VIDEOS videos on the card, its
    first POSEC3D_CPU_VIDEOS with ``--device cpu``; scores within 1e-3
    relative, top-1 equal."""
    from dsgcn_tpu_torch.tools import test as test_cli
    scores = {}
    for device, split in (("cuda", "val"), ("cpu", "cpu")):
        pkl = tmp / f"scores_{device}.pkl"
        args = [str(posec3d_cli_config(tmp, ann, split)), str(wd),
                "--out", str(pkl)]
        t0 = time.perf_counter()
        test_cli.main(args + (["--device", "cpu"] if device == "cpu"
                              else []))
        secs = time.perf_counter() - t0
        scores[device] = load_pickle(pkl)
        n = len(scores[device]["labels"])
        out[f"cli_{device}"] = dict(videos=n, seconds=secs,
                                    clips_per_s=10 * n / secs)
        print(f"posec3d: test CLI on {device}, {n} videos x 10 clips "
              f"in {secs:.2f} s ({10 * n / secs:.2f} clips/s) on {card}",
              flush=True)
    g, c = (torch.from_numpy(np.asarray(scores[d]["scores"]))
            for d in ("cuda", "cpu"))
    check(g.shape == (POSEC3D_VIDEOS, 60)
          and bool(torch.isfinite(g).all()),
          f"posec3d scores of shape {tuple(g.shape)} or not finite")
    n = POSEC3D_CPU_VIDEOS
    err = rel_err(g[:n], c)
    top1 = g[:n].argmax(-1).tolist() == c.argmax(-1).tolist()
    out.update(scores_rel_err=err, top1_equal=top1)
    print(f"posec3d: GPU vs CPU 10-clip scores rel err {err:.3e} on "
          f"{n} videos, top-1 equal {top1}", flush=True)
    check(err <= 1e-3 and top1, f"posec3d: GPU scores off the CPU's by "
          f"{err:.3e} (top-1 equal {top1})")


def posec3d_phase(dev, card, report):
    """Phase 22: PoseC3D (``configs/posec3d/slowonly_ntu60_xsub.py``,
    SlowOnly-R50: 17 heatmap channels in, base 32, blocks (4, 6, 3), 60
    classes) built through ``Config.fromfile`` and ``build_model`` with
    seeded weights.  Serving first, on the seeded model with BatchNorm
    statistics from two test videos' clips (the config's 10-clip test
    pipeline, 48 frames at 64 x 64): a batch forward of their 20 clips
    timed, its logits against a CPU copy's (:func:`posec3d_logits_check`),
    then from a checkpoint the test CLI on POSEC3D_VIDEOS videos on the
    card and on the first POSEC3D_CPU_VIDEOS with ``--device cpu`` (scores
    within 1e-3 relative, top-1 equal).  Training: synthetic hrnet annos
    through the config's train pipeline (clip_len 48, 56 x 56) and the
    port's Loader at b32, each batch's nc = 1 axis dropped by the
    trainer's ``squeeze_clip``, with the host pipeline's seconds a clip;
    one step on the card against the same step on the CPU (phase 7's
    criteria, POSEC3D_CPU_CLIPS clips, dropout off, float64), then timed
    f32 steps over two batches in turn (median of POSEC3D_STEPS after a
    warm-up, dropout 0.5 from the card's generator) with peak memory, one
    profiled; the train CLI on the config for one epoch of two steps with
    its validation.  No kernel of the port may launch."""
    import tempfile
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.trainer import squeeze_clip
    from dsgcn_tpu_torch.data.dataset import Loader, PoseDataset
    from dsgcn_tpu_torch.models.builder import (build_model, init_weights_,
                                                set_dropout_generator)
    out = report["posec3d"] = {}
    t_phase = time.perf_counter()
    reset_counts()
    cfg = Config.fromfile(str(POSEC3D_CONFIG))
    model = build_model(cfg["model"])
    init_weights_(model, torch.Generator().manual_seed(22))
    n_params = sum(p.numel() for p in model.parameters())
    check(type(model).__name__ == "RecognizerPoseC3D"
          and model.fc_cls.in_features == 512 and n_params > 1e6,
          f"the config built {type(model).__name__} with {n_params} "
          f"parameters")
    out["parameters"] = n_params
    model = model.to(dev)
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = pathlib.Path(tmp_s)
        ann = posec3d_annos(tmp, 2 * POSEC3D_BATCH, POSEC3D_VIDEOS, seed=22)

        # serving: the seeded model with BatchNorm statistics from the
        # 'cpu' split's two test videos (the 'val' split's first two)
        val = PoseDataset(str(ann), cfg["data"]["test"]["pipeline"],
                          split="val", test_mode=True)
        clips = torch.from_numpy(np.concatenate(
            [val.prepare(i)["imgs"] for i in range(2)])).to(dev)
        check(clips.shape == (20, 48, 64, 64, 17),
              f"test clips of shape {tuple(clips.shape)}")
        calibrate_posec3d_(model, clips)
        ms, counts = forward_ms(model, clips)
        expect_counts(counts, {}, 1, "posec3d batch forward")
        out["serving"] = dict(batch=list(clips.shape), ms_per_forward=ms,
                              clips_per_s=clips.shape[0] / ms * 1e3)
        print(f"posec3d: eval forward of {tuple(clips.shape)} {ms:.3f} ms "
              f"({clips.shape[0] / ms * 1e3:.1f} clips/s, f32, TF32 off, "
              f"channels_last_3d) on {card}", flush=True)
        posec3d_logits_check(model, clips, card, out["serving"])
        del clips
        wd = tmp / "wd"
        save_checkpoint(model, wd)
        posec3d_test_cli(tmp, ann, wd, card, out["serving"])
        no_launches("posec3d serving")

        dataset = PoseDataset(str(ann), cfg["data"]["train"]["pipeline"],
                              split="train")
        # two distinct b32 batches: the first through the Loader with the
        # config's 8 worker threads, the second on one thread; the timed
        # steps take them in turn
        batches, host_s = [], {}
        for workers in (8, 0):
            loader = Loader(dataset, batch_size=POSEC3D_BATCH, seed=22,
                            drop_last=True, num_workers=workers)
            t0 = time.perf_counter()
            batches.append(squeeze_clip(next(loader.epoch(len(batches)))))
            host_s[f"loader_{workers or 1}_threads"] = (
                (time.perf_counter() - t0) / POSEC3D_BATCH)
        x = batches[0]["imgs"]
        check(x.shape == (POSEC3D_BATCH, 48, 56, 56, 17)
              and x.dtype == np.float32 and 0.5 < float(x.max()) <= 1.0,
              f"a train batch of {x.shape} {x.dtype}, max {float(x.max())}")
        out["host_s_per_clip"] = host_s
        print(f"posec3d: train pipeline through the Loader "
              f"{host_s['loader_8_threads']:.4f} s a clip with 8 threads, "
              f"{host_s['loader_1_threads']:.4f} on one; batches of "
              f"{x.shape}", flush=True)

        # a step on the card against the CPU's, dropout off, in float64:
        # in float32 the loss (6.1e-6) and logits (1.1e-4) agree, but
        # through 40 untrained train-mode BatchNorms single BatchNorm
        # scales' updates differ by ~1% of cosine, rounding of cuDNN's and
        # the CPU's convolutions (an H100 at 700 W, PERF.md §6)
        out["train"] = {}
        probe = copy.deepcopy(model).double()
        probe.dropout = 0.0
        t0 = time.perf_counter()
        gpu_vs_cpu_step(probe, dict(
            imgs=batches[0]["imgs"][:POSEC3D_CPU_CLIPS].astype(np.float64),
            label=batches[0]["label"][:POSEC3D_CPU_CLIPS]), out["train"])
        del probe
        out["train"]["step_check_s"] = time.perf_counter() - t0
        no_launches("posec3d GPU vs CPU step")

        # timed f32 steps at b32, dropout 0.5 from the card's generator, on
        # batches already on the card (the trainer's prefetch copies the
        # next batch during a step); the copy's ms a batch beside them
        from dsgcn_tpu_torch.core.train import make_optimizer, train_step
        set_dropout_generator(model, torch.Generator(device=dev)
                              .manual_seed(22))
        opt, sched = make_optimizer(model, 100, lr=0.2, weight_decay=3e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for b in batches]
        torch.cuda.synchronize()
        out["train"]["h2d_ms_per_batch"] = h2d = (
            (time.perf_counter() - t0) * 1e3 / len(batches))
        rows = []
        for i in range(1 + POSEC3D_STEPS):
            b = batches[i % len(batches)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = train_step(model, opt, sched, b)["loss"].item()
            wall = (time.perf_counter() - t0) * 1e3
            check(np.isfinite(loss), f"posec3d step {i}: loss {loss}")
            rows.append(dict(step=i, warmup=i == 0, loss=loss, wall_ms=wall,
                             peak_mem_gib=torch.cuda.max_memory_allocated()
                             / 2 ** 30))
        timed = [r["wall_ms"] for r in rows[1:]]
        step_ms = float(np.median(timed))
        peak = max(r["peak_mem_gib"] for r in rows)
        out["train"].update(steps=rows, median_step_ms=step_ms,
                            clips_per_s=POSEC3D_BATCH / step_ms * 1e3,
                            peak_mem_gib=peak)
        print(f"posec3d: f32 steps at b{POSEC3D_BATCH} (TF32 off, "
              f"channels_last_3d) "
              f"{', '.join(f'{t:.2f}' for t in timed)} ms, median "
              f"{step_ms:.2f} ms ({POSEC3D_BATCH / step_ms * 1e3:.1f} "
              f"clips/s), peak {peak:.3f} GiB; a batch's copy to the card "
              f"(pageable) {h2d:.2f} ms on {card}", flush=True)
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(model, opt, sched, batches[-1])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        out["train"]["profile"] = device_rows(prof, wall,
                                              "posec3d train profile f32")
        no_launches("posec3d steps")
        del batches, opt, sched, model
        torch.cuda.empty_cache()
        posec3d_train_cli(tmp, ann, out)
        no_launches("posec3d train CLI")
    counts = read_counts()
    expect_counts(counts, {}, 1, "phase 22's steps and forwards")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 22: PoseC3D's steps and forwards launched no kernel of "
          f"the port: {json.dumps(counts)}; {out['seconds']:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 23: DS-GCN with a readout neck (K1-K3), the gcnr and pretraining
# flows, sparse training's backbones (no kernel)
# ---------------------------------------------------------------------------

READOUT_NECK = dict(type="ReadoutNeck", in_channels=256, num_position=25,
                    read_op="mean")
PRETRAIN_NECK = dict(type="PretrainNeck", in_channels=256, num_position=25)
READOUT_CPU_CLIPS = 4               # of the served batch, on the CPU too
READOUT_TRAIN = (128, 2, 60, 25, 3)  # the j config's b128 x T60 steps
MAX_GAP = 1e-4                      # a flipped row's distance gap
SPARSE_BATCH = (16, 2, 100, 25, 3)
SPARSE_RAMP = 3                     # steps over the sparsity ramp to 0.5
SPARSE_WARMUP = 2                   # epochs whose score gradients are gated
SPARSE_MAIN = dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=5e-4)
SPARSE_SCORE = dict(lr=0.1, momentum=0.9, weight_decay=0.0)
SPARSE_CPU_CLIPS = 2                # of a timed batch, stepped on the CPU too


def readout_config(neck):
    """The DS-GCN j config with ``neck`` added to its model."""
    from dsgcn_tpu_torch.configs.config import Config
    cfg = Config.fromfile(str(CONFIG))
    cfg["model"]["neck"] = dict(neck)
    return cfg


def readout_cpu_check(model, x, out):
    """The served model on ``x`` on the card and a CPU copy: each row's
    prototype (flips counted; a flipped row's two distances, on the CPU,
    must lie within MAX_GAP: a tie that rounding decides), and, where no
    row flipped, the logits within 1e-3 of the largest; the card's
    logits must vary over clips and classes by ten times that (phase
    22's rule)."""
    from dsgcn_tpu_torch.models.necks import _rows
    cpu = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        fg, fc = model.backbone(x), cpu.backbone(x.cpu())
        ag, ac = model.neck.assign(fg).cpu(), cpu.neck.assign(fc)
        d = cpu.neck.distance(_rows(fc)[0])
        g, c = model.neck(fg), cpu.neck(fc)
        g, c = model.head(g).cpu(), cpu.head(c)
    flips = (ag != ac).nonzero().flatten()
    gaps = (d[flips, ag[flips]] - d[flips, ac[flips]]).abs()
    err, ferr = rel_err(g, c), rel_err(fg, fc)
    top = g.abs().max()
    over_clips = (g.std(dim=0).mean() / top).item()
    over_classes = (g.std(dim=1).mean() / top).item()
    row = dict(rows=len(ag), flips=len(flips),
               flip_gaps=gaps.tolist(), features_rel_err=ferr,
               logits_rel_err=err, spread_over_clips=over_clips,
               spread_over_classes=over_classes)
    out["cpu_check"] = row
    print(f"readout: card against CPU on {x.shape[0]} clips: {len(flips)} "
          f"of {len(ag)} rows assigned another prototype (gaps "
          f"{gaps.tolist()}), features {ferr:.3e}, logits {err:.3e} of the "
          f"largest; logit spread over clips {over_clips:.3e}, over classes "
          f"{over_classes:.3e}", flush=True)
    check(bool(torch.isfinite(g).all()) and ferr <= 1e-3,
          f"readout: GPU features off the CPU's by {ferr:.3e}")
    if len(flips):
        check(gaps.max().item() <= MAX_GAP,
              f"readout: rows flipped with distance gaps {gaps.tolist()}")
    else:
        check(err <= 1e-3, f"readout: GPU logits off the CPU's by {err:.3e}")
    check(over_clips >= 1e-2 and over_classes >= 1e-2,
          f"readout: logits spread {over_clips:.3e} over clips and "
          f"{over_classes:.3e} over classes, under 1e-2 of the largest")


def readout_serving(dev, card, out):
    """DS-GCN j with a ReadoutNeck through ``init_recognizer`` /
    ``inference_recognizer`` (calibrated, two requests), a b64 x M2 x T100
    batch forward (10 K3 launches, none of K1/K2) with its ms, profile
    and peak memory, and the card against the CPU
    (:func:`readout_cpu_check`)."""
    from dsgcn_tpu_torch.apis import inference_recognizer, init_recognizer
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.models.necks import ReadoutNeck
    cfg = readout_config(READOUT_NECK)
    torch.manual_seed(23)
    model = init_recognizer(cfg, device=dev)
    check(isinstance(model.neck, ReadoutNeck)
          and model.backbone.num_blocks == 10,
          f"the config built a {type(model.neck).__name__} neck")
    pipeline = build_pipeline(cfg["data"]["test"]["pipeline"])
    calibrate_(model, torch.from_numpy(pipeline(synthetic_annos(seed=1)[0])[
        "keypoint"]).to(dev), seed=23)
    reset_counts()
    request_ms, answers = [], []
    annos = synthetic_annos(seed=2, n=2)
    for a in annos:
        t0 = time.perf_counter()
        answers.append(inference_recognizer(model, a))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    expect_counts(read_counts(), {"bd_dyn_graph_agg": 10}, len(annos),
                  "readout requests")
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        THROUGHPUT_BATCH).astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ms, counts = forward_ms(model, x)
    expect_counts(counts, {"bd_dyn_graph_agg": 10}, 1,
                  "readout batch forward")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out.update(request_ms=request_ms, top5=answers, ms_per_forward=ms,
               clips_per_s=x.shape[0] / ms * 1e3, peak_mem_gib=peak,
               launches_per_forward=counts)
    print(f"readout: requests {', '.join(f'{t:.3f}' for t in request_ms)} "
          f"ms; batch {tuple(x.shape)} {ms:.3f} ms/forward "
          f"({x.shape[0] / ms * 1e3:.1f} clips/s), peak {peak:.3f} GiB, "
          f"launches {json.dumps(counts)} on {card}", flush=True)
    breakdown(model, x, "f32", out, "DS-GCN+ReadoutNeck ")
    readout_cpu_check(model, x[:READOUT_CPU_CLIPS], out)
    return counts


def gcnr_step(model, opt, sched, batch):
    """One step of the readout recognizer's objective (``gcnr_losses``:
    cross entropy of the head over the neck's readout plus the neck's
    ``get_aligncost``), of ``train_step``'s signature."""
    from dsgcn_tpu_torch.core.flows import gcnr_losses
    model.train()
    dev = next(model.parameters()).device
    x = torch.as_tensor(batch["keypoint"]).to(dev)
    feats = model.backbone(x)
    losses = gcnr_losses(model.head(model.neck(feats)),
                         torch.as_tensor(batch["label"]).to(dev),
                         model.neck.get_aligncost(feats))
    return _apply_step(model, opt, sched, losses["loss"])


def pretrain_step(model, opt, sched, batch):
    """One masked-pretraining step (``mask_keypoints_at`` with the batch's
    ``drop`` joints, both views through the backbone, ``pretrain_losses``
    of the PretrainNeck), of ``train_step``'s signature."""
    from dsgcn_tpu_torch.core.flows import mask_keypoints_at, pretrain_losses
    model.train()
    dev = next(model.parameters()).device
    x = torch.as_tensor(batch["keypoint"]).to(dev)
    masked, mask = mask_keypoints_at(x, torch.as_tensor(batch["drop"]))
    losses = pretrain_losses(model.neck, model.backbone(x),
                             model.backbone(masked), mask)
    return _apply_step(model, opt, sched, losses["loss_cls"])


def _apply_step(model, opt, sched, loss):
    from dsgcn_tpu_torch.core.train import zero_missing_grads_
    opt.zero_grad(set_to_none=True)
    loss.backward()
    zero_missing_grads_(opt)
    opt.step()
    sched.step()
    return {"loss": loss.detach()}


def neck_batches(seed, n=1 + EXTRA_STEPS):
    """Seeded b128 x M2 x T60 batches (60 classes) with the joints a
    masked view drops (12 a skeleton, as ``mask_keypoints`` at 0.5)."""
    rng = np.random.default_rng(seed)
    n_sk = READOUT_TRAIN[0] * READOUT_TRAIN[1]
    return [dict(keypoint=rng.standard_normal(READOUT_TRAIN).astype(
                     np.float32),
                 label=rng.integers(0, 60, READOUT_TRAIN[0]),
                 drop=np.stack([rng.permutation(25)[:12]
                                for _ in range(n_sk)]))
            for _ in range(n)]


def neck_training(dev, card, out):
    """DS-GCN j with a neck in training: ``train_step`` with the
    ReadoutNeck, the gcnr objective (ReadoutNeck + GCNHead) and masked
    pretraining (PretrainNeck(256, 25)), each one step on the card against
    the CPU (phase 7's criteria, float32 on the kernel path, on the
    first CPU_CHECK_CLIPS clips of the timed batch) and timed f32 steps at
    b128 x M2 x T60 (10 K1 and 10 K2
    launches a backbone pass: 10 a step, 20 for pretraining's two views)
    with their peak memory; one step of each profiled."""
    from dsgcn_tpu_torch.core.train import make_optimizer, train_step
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    batches = neck_batches(23)
    clips = CPU_CHECK_CLIPS
    small = dict(keypoint=batches[0]["keypoint"][:clips],
                 label=batches[0]["label"][:clips],
                 drop=batches[0]["drop"][:clips * READOUT_TRAIN[1]])
    for name, neck, step, passes in (
            ("readout", READOUT_NECK, train_step, 1),
            ("gcnr", READOUT_NECK, gcnr_step, 1),
            ("pretrain", PRETRAIN_NECK, pretrain_step, 2)):
        t0 = time.perf_counter()
        o = out[name] = {}
        gen = torch.Generator().manual_seed(23)
        model = init_weights_(build_model(readout_config(neck)["model"]),
                              gen)
        nudge_gates_(model, gen)
        model = model.to(dev)
        gpu_vs_cpu_step(model, small, o, step)
        per_step = {k: 10 * passes for k in K1K2}
        o["steps"] = step_times(model, batches, per_step, card,
                                f"DS-GCN+{name}", step)
        timed = [r["wall_ms"] for r in o["steps"][1:]]
        o["median_step_ms"] = float(np.median(timed))
        o["clips_per_s"] = READOUT_TRAIN[0] / o["median_step_ms"] * 1e3
        from torch.profiler import ProfilerActivity, profile
        opt, sched = make_optimizer(model, 10)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            (step or train_step)(model, opt, sched, batches[0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        o["profile"] = device_rows(prof, wall, f"DS-GCN+{name} step profile")
        o["seconds"] = time.perf_counter() - t0
        del model, opt
        torch.cuda.empty_cache()


class SparseClassifier(torch.nn.Module):
    """A sparse backbone and a linear head over its pooled feature (JAX
    composes its sparse backbones by hand too), masked at
    ``self.sparsity``: a sparsity, or for ``AssembleSparse`` the (epoch,
    max epoch) pair, whose B streams' pooled features are summed."""

    def __init__(self, backbone, num_classes=60):
        super().__init__()
        self.backbone = backbone
        self.fc_cls = torch.nn.Linear(backbone.out_channels, num_classes)
        self.sparsity = 0.0

    def mask_args(self):
        s = self.sparsity
        return s if isinstance(s, tuple) else (s,)

    def forward(self, x):
        pooled = self.backbone(x, *self.mask_args()).mean(dim=(-4, -3, -2))
        return self.fc_cls(pooled if pooled.dim() == 2 else pooled.sum(0))

    def penalty(self):
        """The recipe's group lasso (1e-4): the masked one of the sparse
        kernels, or Assemble's regularizer (GSGL over pruned weights)."""
        from dsgcn_tpu_torch.sparse.nested import (AssembleSparse,
                                                   assemble_regularize)
        from dsgcn_tpu_torch.sparse.supermask import group_lasso_penalty
        if isinstance(self.backbone, AssembleSparse):
            return assemble_regularize(self.backbone, 1e-4)
        return group_lasso_penalty(self.backbone, 1e-4, self.sparsity)

    def set_epoch(self, epoch, total):
        """The backbone's sparsity ramp at ``epoch`` of ``total``."""
        from dsgcn_tpu_torch.sparse.nested import AssembleSparse
        self.sparsity = ((epoch, total)
                         if isinstance(self.backbone, AssembleSparse)
                         else self.backbone.epoch_sparsity(epoch, total))

    def sparsities(self):
        """The sparsity of each threshold pool's schedule (Assemble: one a
        branch)."""
        bb = self.backbone
        if isinstance(self.sparsity, tuple):
            return [bb.branch_sparsity(j, *self.sparsity)
                    for j in range(len(bb.model_list))]
        return [self.sparsity]


def sparse_step(model, opt, gate, batch, epoch):
    """One step of the sparse recipe: cross entropy plus the model's
    penalty, the score gradients gated by ``epoch``."""
    from dsgcn_tpu_torch.core.losses import cross_entropy
    model.train()
    dev = next(model.parameters()).device
    loss = cross_entropy(model(torch.as_tensor(batch["keypoint"]).to(dev)),
                         torch.as_tensor(batch["label"]).to(dev)) \
        + model.penalty()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    gate(epoch)
    opt.step()
    return {"loss": loss.detach()}


def sparse_opt_step(model, opt, sched, batch):
    """:func:`sparse_step` after the warm-up with its own
    ``make_sparse_optimizer``, of ``train_step``'s signature (the
    optimizer given is not used)."""
    from dsgcn_tpu_torch.sparse.supermask import make_sparse_optimizer
    sopt, gate = make_sparse_optimizer(model, SPARSE_MAIN, SPARSE_SCORE,
                                       SPARSE_WARMUP)
    return sparse_step(model, sopt, gate, batch, SPARSE_WARMUP)


def sparse_masks(model):
    """{kernel: mask} of every sparse kernel at the model's sparsity (each
    block's threshold; STGCN_sparse's and AAGCN_sparse's residuals at 0)
    and, per threshold pool, how far the fraction of its scores kept lies
    from 1 - its sparsity."""
    from dsgcn_tpu_torch.sparse import models as sm
    from dsgcn_tpu_torch.sparse.nested import AssembleSparse, \
        SparseAAGCNBlock
    from dsgcn_tpu_torch.sparse.supermask import sparse_kernels
    bb = model.backbone
    masks, kept_err = {}, []
    with torch.no_grad():
        if isinstance(bb, AssembleSparse):
            sp = model.sparsities()
            blocks = [(f"stage{i}_branch{j}", bb.block(i, j), thr, sp[j])
                      for i, row in enumerate(bb.thresholds(*model.sparsity))
                      for j, thr in enumerate(row)]
        else:
            blocks = [(f"block{i}", blk, thr, model.sparsity)
                      for i, (blk, thr) in enumerate(zip(
                          bb.blocks(), bb.thresholds(model.sparsity)))]
        for name, blk, thr, sparsity in blocks:
            for kname, k in sparse_kernels(blk):
                at_zero = isinstance(blk, (sm.SparseSTGCNBlockExact,
                                           SparseAAGCNBlock)) \
                    and kname.startswith("residual")
                masks[f"{name}.{kname}"] = k.mask(0.0 if at_zero else thr)
                if isinstance(bb, sm.SparseSTGCN):
                    kept_err.append(abs(masks[f"{name}.{kname}"].mean()
                                        .item() - (1 - sparsity)))
            if not isinstance(bb, sm.SparseSTGCN):
                pool = (sm._block_score_pool
                        if isinstance(bb, sm.SparseCTRGCN)
                        and not bb.pool_all_scores else sm._all_score_pool)
                s = torch.cat([p.reshape(-1) for p in pool(blk)])
                kept_err.append(abs((s >= thr).double().mean().item()
                                    - (1 - sparsity)))
    return masks, kept_err


def sparse_builds():
    """Phase 23's backbones: (name, build, epochs of the ramp, the dtype of
    the check against the CPU)."""
    from dsgcn_tpu_torch.sparse import models as sm
    return (
        ("SparseSTGCN", lambda: sm.SparseSTGCN(target_sparsity=0.5),
         SPARSE_RAMP, torch.float32),
        ("SparseCTRGCN", lambda: sm.SparseCTRGCN(
            linear_sparsity=0.5, sparse_decay=True), 2 * SPARSE_RAMP,
         torch.float64),
        ("SparseSTGCNExact", lambda: sm.SparseSTGCNExact(
            linear_sparsity=0.5, sparse_decay=True), 2 * SPARSE_RAMP,
         torch.float32))


def sparse_training(dev, card, out, builds, seed=24, bias=(1.0, 2.0)):
    """Sparse backbones at their defaults (10 stages, base 64), each with a
    linear head (``SparseClassifier``): SPARSE_RAMP f32 steps at b16 x M2
    x T100 up the sparsity ramp to 0.5 (``set_epoch``;
    ``make_sparse_optimizer`` with the scores gated for SPARSE_WARMUP
    epochs, the model's penalty) with ms, clips/s and peak memory, one
    profiled (the card's activity only: the host's tens of thousands of
    op events took the profile's analysis 5-15 s); after each, every
    threshold pool keeps within 0.05 of 1 -
    its sparsity; the masks on the card equal a CPU copy's; one step
    against the CPU at the ramp's end (phase 7's criteria, on the first
    SPARSE_CPU_CLIPS clips of a timed batch) in the build's dtype: float64
    where the float32 step strays from float64 on the CPU alone (a gate
    such as CTRGC's ``alpha`` starts at 0; PERF.md §6).  The
    zero-initialised biases of the thresholded layers are first drawn from
    U(``bias``).  No kernel of the port launches."""
    from dsgcn_tpu_torch.models.builder import init_weights_
    from dsgcn_tpu_torch.sparse.supermask import (make_sparse_optimizer,
                                                  sparse_kernels)
    rng = np.random.default_rng(seed)
    batches = [dict(keypoint=rng.standard_normal(SPARSE_BATCH).astype(
                        np.float32),
                    label=rng.integers(0, 60, SPARSE_BATCH[0]))
               for _ in range(2)]
    cpu_batch = dict(keypoint=batches[0]["keypoint"][:SPARSE_CPU_CLIPS],
                     label=batches[0]["label"][:SPARSE_CPU_CLIPS])
    for i, (name, build, total, check_dtype) in enumerate(builds):
        t0 = time.perf_counter()
        o = out[name] = {}
        gen = torch.Generator().manual_seed(seed + i)
        model = init_weights_(SparseClassifier(build()), gen)
        with torch.no_grad():
            # the zero-initialised biases (the thresholded layers') before
            # a train-mode BatchNorm get a gradient of rounding noise only,
            # all of their update: at U(1, 2) the weight decay's moves them,
            # the same on the card and the CPU (nudge_pre_bn_biases_)
            for _, k in sparse_kernels(model):
                if k.zero_bias:
                    k.bias.uniform_(*bias, generator=gen)
        bb = model.backbone
        stages = getattr(bb, "num_blocks", getattr(bb, "num_stages", None))
        check(stages == 10, f"{name}: {stages} stages")
        model.set_epoch(total, total)
        gpu_vs_cpu_step(copy.deepcopy(model).to(dev, check_dtype), dict(
            cpu_batch, keypoint=cpu_batch["keypoint"].astype(
                np.float64 if check_dtype == torch.float64 else np.float32)),
            o.setdefault(str(check_dtype).split(".")[-1], {}),
            sparse_opt_step)
        model = model.to(dev)
        opt, gate = make_sparse_optimizer(model, SPARSE_MAIN, SPARSE_SCORE,
                                          SPARSE_WARMUP)
        rows = []
        for epoch in range(1, SPARSE_RAMP + 1):
            model.set_epoch(epoch, total)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t1 = time.perf_counter()
            loss = sparse_step(model, opt, gate, batches[epoch % 2],
                               epoch)["loss"].item()
            wall = (time.perf_counter() - t1) * 1e3
            no_launches(f"{name} step {epoch}")
            _, kept_err = sparse_masks(model)
            worst = max(kept_err)
            rows.append(dict(epoch=epoch, sparsity=model.sparsities(),
                             loss=loss, wall_ms=wall,
                             peak_mem_gib=torch.cuda.max_memory_allocated()
                             / 2 ** 30, worst_kept_err=worst,
                             scores_gated=epoch < SPARSE_WARMUP))
            check(np.isfinite(loss), f"{name} epoch {epoch}: loss {loss}")
            check(worst <= 0.05, f"{name} epoch {epoch}: a pool keeps "
                  f"{worst:.3f} off 1 - its sparsity {model.sparsities()}")
        masks_g, _ = sparse_masks(model)
        cpu = copy.deepcopy(model).cpu()
        masks_c, _ = sparse_masks(cpu)
        differ = sum(int((masks_g[k].cpu() != masks_c[k]).sum())
                     for k in masks_c)
        check(differ == 0, f"{name}: {differ} mask entries differ between "
              f"the card and the CPU")
        del cpu
        timed = [r["wall_ms"] for r in rows[1:]]
        o.update(steps=rows, masks=len(masks_g), mask_entries_differing=0,
                 median_step_ms=float(np.median(timed)),
                 clips_per_s=SPARSE_BATCH[0] / np.median(timed) * 1e3,
                 peak_mem_gib=max(r["peak_mem_gib"] for r in rows))
        print(f"{name}: f32 steps at b{SPARSE_BATCH[0]} over sparsity "
              f"{json.dumps([r['sparsity'] for r in rows])}: "
              f"{', '.join('%.2f' % r['wall_ms'] for r in rows)} ms (first "
              f"a warm-up), peak {o['peak_mem_gib']:.3f} GiB; pools keep "
              f"within {max(r['worst_kept_err'] for r in rows):.4f} of 1 - "
              f"sparsity; {len(masks_g)} masks equal on the card and the "
              f"CPU, on {card}", flush=True)
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            sparse_step(model, opt, gate, batches[0], SPARSE_RAMP)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        o["profile"] = device_rows(prof, wall, f"{name} step profile")
        no_launches(f"{name} profiled step")
        o["seconds"] = time.perf_counter() - t0
        del model, opt
        torch.cuda.empty_cache()


def readouts_phase(dev, card, report):
    """Phase 23: DS-GCN j with a neck (``cfg['model']['neck']``, no new
    config file): serving with a ReadoutNeck (K3, :func:`readout_serving`),
    its train step, the gcnr and pretraining steps (K1 + K2,
    :func:`neck_training`), then the sparse backbones
    (:func:`sparse_training`, no kernel)."""
    out = report["readouts"] = {}
    t0 = time.perf_counter()
    readout_serving(dev, card, out.setdefault("serving", {}))
    t1 = time.perf_counter()
    neck_training(dev, card, out.setdefault("train", {}))
    t2 = time.perf_counter()
    sparse_training(dev, card, out.setdefault("sparse", {}), sparse_builds())
    out["seconds"] = dict(serving=t1 - t0, train=t2 - t1,
                          sparse=time.perf_counter() - t2,
                          total=time.perf_counter() - t0)
    print(f"phase 23: readout serving {t1 - t0:.1f} s, neck training "
          f"{t2 - t1:.1f} s, sparse training {time.perf_counter() - t2:.1f} "
          f"s", flush=True)


# ---------------------------------------------------------------------------
# phase 24: the nested sparse backbones, AssembleSparse, the SMoE backbone
# and expert parallelism (no kernel)
# ---------------------------------------------------------------------------

SMOE_EXPERTS = ("ST-GCN", "AA-GCN", "CTR-GCN", "DG-GCN", "ST-GCN")
SMOE_WARMUP = 2                     # epochs with the regularizer in the loss
SMOE_EPOCHS = (1, 2, 3)             # timed steps: inside and past the warm-up
SMOE_MAX_EPOCH = 2 * SPARSE_RAMP
SMOE_FORWARDS = 5                   # timed eval forwards
EP_EXPERTS = ("ST-GCN",) * 3        # two routed experts and the base
EP_TOL = 1e-5
# the thresholded layers' biases before a BatchNorm, off zero but small: a
# channel whose inputs are all masked is its bias alone, and at U(1, 2) the
# sum of AAGCN's three subsets' biases made E[x^2] - E[x]^2 negative in
# float32 (NaN from the first block's BatchNorm; JAX's formula, kept)
NESTED_BIAS = (-0.2, 0.2)


def dg_random_graph():
    """SparseDGSTGCN's default graph (random, K = 8), seeded."""
    from dsgcn_tpu_torch.graph import GraphConfig
    return GraphConfig(layout="nturgb+d", mode="random", num_filter=8,
                       init_off=0.04, init_std=0.02, seed=24)


def nested_builds():
    """Phase 24 (a) and (b): SparseAAGCN and SparseDGSTGCN at their
    defaults, and AssembleSparse over the four families on the random
    K = 8 graph (two subsets a branch); float64 checks (their gates start
    at 0)."""
    from dsgcn_tpu_torch.sparse import nested as sn
    return (
        ("SparseAAGCN", lambda: sn.SparseAAGCN(
            linear_sparsity=0.5, sparse_decay=True), 2 * SPARSE_RAMP,
         torch.float64),
        ("SparseDGSTGCN", lambda: sn.SparseDGSTGCN(
            graph_cfg=dg_random_graph(), linear_sparsity=0.5,
            sparse_decay=True), 2 * SPARSE_RAMP, torch.float64)), (
        ("AssembleSparse", lambda: sn.AssembleSparse(
            SMOE_EXPERTS[:4], (0.5,) * 4, graph_cfg=dg_random_graph(),
            sparse_decay=True), 2 * SPARSE_RAMP, torch.float64),)


class SMoEClassifier(torch.nn.Module):
    """SMoEAssembleSparse and a ClsHead (60 classes, no dropout, so the
    card's step and the CPU's see the same network) over its combined
    feature, at ``self.epoch`` of SMOE_MAX_EPOCH; the gate's noise from
    ``self.generator`` or, when set, ``self.gate_noise``; ``self.aux``
    keeps the last balance loss."""

    def __init__(self, smoe):
        super().__init__()
        from dsgcn_tpu_torch.models.heads import ClsHead
        self.smoe = smoe
        self.head = ClsHead(60, smoe.out_channel, dropout=0.0)
        self.epoch, self.generator, self.gate_noise = 1, None, None
        self.aux = None

    def forward(self, x):
        feat, self.aux = self.smoe(x, self.epoch, SMOE_MAX_EPOCH,
                                   self.generator, self.gate_noise)
        return self.head(feat)


def smoe_step(model, opt, gate, batch):
    """One SMoE recognizer step: ``smoe_recognizer_losses`` (CE, the
    balance loss, and while the epoch is within SMOE_WARMUP the gradual
    lam times ``smoe_regularize``), the score gradients gated by the
    epoch."""
    from dsgcn_tpu_torch.core.flows import smoe_recognizer_losses
    from dsgcn_tpu_torch.sparse.smoe import smoe_regularize
    model.train()
    dev = next(model.parameters()).device
    logits = model(torch.as_tensor(batch["keypoint"]).to(dev))
    pen = smoe_regularize(model.smoe, 1.0) \
        if model.epoch <= SMOE_WARMUP else None
    losses = smoe_recognizer_losses(
        logits, torch.as_tensor(batch["label"]).to(dev), model.aux,
        current_epoch=model.epoch, warm_up=SMOE_WARMUP, penalty_value=pen)
    opt.zero_grad(set_to_none=True)
    losses["loss"].backward()
    gate(model.epoch)
    opt.step()
    return {k: v.detach() for k, v in losses.items()}


def smoe_opt_step(model, opt, sched, batch):
    """:func:`smoe_step` with its own ``make_sparse_optimizer``, of
    ``train_step``'s signature (the optimizer given is not used)."""
    from dsgcn_tpu_torch.sparse.supermask import make_sparse_optimizer
    sopt, gate = make_sparse_optimizer(model, SPARSE_MAIN, SPARSE_SCORE,
                                       SPARSE_WARMUP)
    return smoe_step(model, sopt, gate, batch)


def smoe_model(models, seed):
    """The SMoE over ``models`` at full width (10 stages, base 64, ratio
    0.5 each, k = 1, noisy gating), seeded (``init_weights_``), the zero
    biases before BatchNorms from U(NESTED_BIAS) and the gate's zero
    weights drawn N(0, 0.1), so the gates route by the features from the
    first step."""
    from dsgcn_tpu_torch.models.builder import init_weights_
    from dsgcn_tpu_torch.sparse.smoe import SMoEAssembleSparse
    from dsgcn_tpu_torch.sparse.supermask import sparse_kernels
    gen = torch.Generator().manual_seed(seed)
    model = init_weights_(SMoEClassifier(SMoEAssembleSparse(
        models, (0.5,) * len(models), k_num=1, noisy_gating=True,
        out_channel=256, sparse_decay=True)), gen)
    with torch.no_grad():
        for _, k in sparse_kernels(model):
            if k.zero_bias:
                k.bias.uniform_(*NESTED_BIAS, generator=gen)
        for w in (model.smoe.gate.w_gate, model.smoe.gate.w_noise):
            w.normal_(0.0, 0.1, generator=gen)
    return model


def routed(gates):
    """Samples a routed expert takes (its gate nonzero), by expert."""
    return (gates > 0).sum(0).tolist()


def smoe_training(dev, card, out):
    """Part (c): SMoEAssembleSparse over four routed experts (ST-GCN,
    AA-GCN, CTR-GCN, DG-GCN) and an ST-GCN base, with a ClsHead and
    ``smoe_recognizer_losses`` including ``smoe_regularize``: one step
    against the CPU in float64 with the same injected gate noise (phase
    7's criteria), timed b16 x M2 x T100 steps inside and past the
    warm-up with noise from a generator on the card (ms, clips/s, peak
    GiB, one profiled for the idle share, the card's activity only), the
    experts the gates picked,
    and an eval forward (clips/s, logits against the CPU within 1e-3 on
    SPARSE_CPU_CLIPS clips, the same routing).  No kernel launches."""
    from dsgcn_tpu_torch.sparse.supermask import make_sparse_optimizer
    t0 = time.perf_counter()
    rng = np.random.default_rng(25)
    batches = [dict(keypoint=rng.standard_normal(SPARSE_BATCH).astype(
                        np.float32),
                    label=rng.integers(0, 60, SPARSE_BATCH[0]))
               for _ in range(2)]
    model = smoe_model(SMOE_EXPERTS, 25)
    E = model.smoe.num_experts
    check(E == 4 and model.smoe.expert(E).num_blocks == 10,
          f"SMoE: {E} routed experts")
    cpu_batch = dict(keypoint=batches[0]["keypoint"][
        :SPARSE_CPU_CLIPS].astype(np.float64),
        label=batches[0]["label"][:SPARSE_CPU_CLIPS])
    checked = copy.deepcopy(model).to(dev, torch.float64)
    checked.epoch = SMOE_WARMUP
    checked.gate_noise = torch.from_numpy(rng.standard_normal(
        (SPARSE_CPU_CLIPS, E)))
    gpu_vs_cpu_step(checked, cpu_batch, out.setdefault("float64", {}),
                    smoe_opt_step)
    del checked
    model = model.to(dev)
    model.generator = torch.Generator(device=dev).manual_seed(25)
    opt, gate = make_sparse_optimizer(model, SPARSE_MAIN, SPARSE_SCORE,
                                      SPARSE_WARMUP)
    rows = []
    for i, epoch in enumerate(SMOE_EPOCHS):
        model.epoch = epoch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        losses = {k: v.item() for k, v in smoe_step(
            model, opt, gate, batches[i % 2]).items()}
        wall = (time.perf_counter() - t1) * 1e3
        no_launches(f"SMoE step at epoch {epoch}")
        rows.append(dict(epoch=epoch, losses=losses, wall_ms=wall,
                         routed=routed(model.smoe.gates),
                         peak_mem_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30))
        check(all(np.isfinite(v) for v in losses.values()),
              f"SMoE epoch {epoch}: losses {losses}")
        check(("panelty_loss" in losses) == (epoch <= SMOE_WARMUP),
              f"SMoE epoch {epoch}: the penalty {losses}")
        print(f"SMoE step at epoch {epoch}: {json.dumps(rows[-1])} on "
              f"{card}", flush=True)
    timed = [r["wall_ms"] for r in rows[1:]]
    out.update(steps=rows, median_step_ms=float(np.median(timed)),
               clips_per_s=SPARSE_BATCH[0] / np.median(timed) * 1e3,
               peak_mem_gib=max(r["peak_mem_gib"] for r in rows))
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        smoe_step(model, opt, gate, batches[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    out["profile"] = device_rows(prof, wall, "SMoE step profile")
    no_launches("SMoE profiled step")
    # serving: the eval forward of a b16 batch, and on the CPU
    model.eval()
    x = torch.from_numpy(batches[1]["keypoint"]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    ms, counts = forward_ms(model, x, SMOE_FORWARDS)
    expect_counts(counts, {}, 1, "an SMoE eval forward")
    gates_g = model.smoe.gates
    cpu = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        lg = model(x[:SPARSE_CPU_CLIPS]).cpu()
        lc = cpu(x[:SPARSE_CPU_CLIPS].cpu())
    err = rel_err(lg, lc)
    same = torch.equal(model.smoe.gates.cpu() > 0, cpu.smoe.gates > 0)
    out["eval"] = dict(forward_ms=ms, clips_per_s=SPARSE_BATCH[0] / ms * 1e3,
                       peak_mem_gib=torch.cuda.max_memory_allocated()
                       / 2 ** 30, logits_rel_err=err, routed=routed(gates_g),
                       same_routing_on_cpu=same)
    print(f"SMoE eval forward b{SPARSE_BATCH[0]}: {ms:.3f} ms "
          f"({out['eval']['clips_per_s']:.1f} clips/s), routed "
          f"{routed(gates_g)}; logits against the CPU {err:.3e} of the "
          f"largest, on {card}", flush=True)
    check(same, "SMoE: the card and the CPU route differently")
    check(err <= 1e-3, f"SMoE eval logits off the CPU's by {err:.3e}")
    out["seconds"] = time.perf_counter() - t0
    del model, opt, cpu
    torch.cuda.empty_cache()


def ep_config():
    """The SMoE of part (d), on the meta device: its configuration."""
    from dsgcn_tpu_torch.sparse.smoe import SMoEAssembleSparse
    with torch.device("meta"):
        return SMoEAssembleSparse(EP_EXPERTS, (0.5,) * 3, k_num=1,
                                  sparse_decay=True)


def ep_part(work):
    """Part (d), in each of a two-process launch: gloo, both processes on
    cuda:0, rank e running routed expert e of the SMoE whose state the
    phase saved (``make_ep_smoe_eval``); the feature and balance loss of
    the b16 eval batch, the launches, the parameters this rank holds."""
    import torch.distributed as dist
    from dsgcn_tpu_torch.parallel.expert_parallel import (make_ep_smoe_eval,
                                                          make_expert_mesh)
    from dsgcn_tpu_torch.parallel.mesh import init_distributed
    dev = init_distributed("gloo", device="cuda:0")
    state = torch.load(work / "ep_state.pt", weights_only=True)
    x = torch.load(work / "ep_x.pt", weights_only=True).to(dev)
    run = make_ep_smoe_eval(make_expert_mesh(dist.get_world_size()),
                            ep_config())
    reset_counts()
    feat, aux = run(state, x, SMOE_MAX_EPOCH, SMOE_MAX_EPOCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feat, aux = run(state, x, SMOE_MAX_EPOCH, SMOE_MAX_EPOCH)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    torch.save(dict(feat=feat.cpu(), aux=aux.cpu(), ms=ms,
                    launches=read_counts(),
                    held=sum(p.numel() for m in run.modules
                             for p in m.parameters())),
               work / f"ep{dist.get_rank()}.pt")
    return dict(rank=dist.get_rank(), backend=dist.get_backend())


def expert_parallel(dev, card, out, tmp):
    """Part (d): the SMoE of EP_EXPERTS (two routed ST-GCN experts and an
    ST-GCN base) at full width, seeded (distinct experts), ``w_gate``
    set so that both experts take samples: its dense eval forward on the
    card, then two gloo
    processes on cuda:0 (``torchrun``; NCCL refuses two ranks on one
    device), each rank's feature and balance loss within EP_TOL of the
    dense ones, no launch of the port's kernels."""
    from dsgcn_tpu_torch.sparse.smoe import _pool
    t0 = time.perf_counter()
    model = smoe_model(EP_EXPERTS, 26).to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(26).standard_normal(
        SPARSE_BATCH).astype(np.float32))
    smoe, gen = model.smoe, torch.Generator(device=dev).manual_seed(26)
    with torch.no_grad():
        # the pooled features share a large mean: a gate of two opposite
        # columns along a random direction orthogonal to the batch's mean
        # routes by each sample's own part, so both experts take samples
        base = smoe.expert(smoe.num_experts)
        f = _pool(base(x.to(dev), base.epoch_sparsity(SMOE_MAX_EPOCH,
                                                       SMOE_MAX_EPOCH)))
        m = f.mean(0)
        u = torch.randn(m.shape, generator=gen, device=dev)
        w = u - (u @ m) / (m @ m) * m
        w = w / (f @ w).std()
        smoe.gate.w_gate.copy_(torch.stack([w, -w], 1))
        feat, aux = smoe(x.to(dev), SMOE_MAX_EPOCH, SMOE_MAX_EPOCH)
    gates = smoe.gates
    check(min(routed(gates)) > 0, f"EP: the gates route {routed(gates)}")
    torch.save({k: v.cpu() for k, v in model.smoe.state_dict().items()},
               tmp / "ep_state.pt")
    torch.save(x, tmp / "ep_x.pt")
    held_dense = sum(p.numel() for p in model.smoe.parameters())
    del model
    torch.cuda.empty_cache()
    rc, secs, err = torchrun(2, "ep", tmp, timeout=300)
    check(rc == 0, f"expert-parallel launch exited {rc}:\n{err}")
    rows = []
    for r in range(2):
        got = torch.load(tmp / f"ep{r}.pt", weights_only=True)
        fe = rel_err(got["feat"], feat)
        ae = abs(got["aux"].item() - aux.item()) / abs(aux.item())
        rows.append(dict(rank=r, feat_rel_err=fe, aux_rel_err=ae,
                         ms=got["ms"], held_params=got["held"],
                         launches=got["launches"]))
        expect_counts(got["launches"], {}, 1, f"EP rank {r}")
        check(fe <= EP_TOL and ae <= EP_TOL, f"EP rank {r}: feature "
              f"{fe:.3e}, aux {ae:.3e} off the dense SMoE")
    out.update(ranks=rows, routed=routed(gates), launch_s=secs,
               dense_params=held_dense, seconds=time.perf_counter() - t0)
    print(f"expert parallelism, 2 gloo processes on cuda:0: {json.dumps(rows)}"
          f"; routed {routed(gates)} of {SPARSE_BATCH[0]}; dense holds "
          f"{held_dense} parameters; launch {secs:.1f} s, on {card}",
          flush=True)


def smoe_phase(dev, card, report):
    """Phase 24: (a) SparseAAGCN and SparseDGSTGCN, (b) AssembleSparse,
    each through :func:`sparse_training`; (c) the SMoE recognizer
    (:func:`smoe_training`); (d) expert parallelism
    (:func:`expert_parallel`).  No kernel."""
    import tempfile
    out = report["smoe"] = {}
    nested, assemble = nested_builds()
    t = [time.perf_counter()]
    sparse_training(dev, card, out.setdefault("nested", {}), nested, seed=27,
                    bias=NESTED_BIAS)
    t.append(time.perf_counter())
    sparse_training(dev, card, out.setdefault("assemble", {}), assemble,
                    seed=28, bias=NESTED_BIAS)
    t.append(time.perf_counter())
    smoe_training(dev, card, out.setdefault("smoe", {}))
    t.append(time.perf_counter())
    with tempfile.TemporaryDirectory() as tmp:
        expert_parallel(dev, card, out.setdefault("ep", {}),
                        pathlib.Path(tmp))
    t.append(time.perf_counter())
    out["seconds"] = dict(zip(("nested", "assemble", "smoe", "ep"),
                              np.diff(t).tolist()), total=t[-1] - t[0])
    print(f"phase 24: {json.dumps(out['seconds'])}", flush=True)


# ---------------------------------------------------------------------------
# phase 25: the 3D-CNN, video and multimodal models (no kernel)
# ---------------------------------------------------------------------------

VIDEO_BATCH = 8                 # RGB+pose and SlowFast clips a step
HEATMAP_BATCH = 32              # X3D, C3D and PoTion (PoseC3D's b32)
VIDEO_STEPS = 3                 # timed steps after a warm-up
VIDEO_FRAMES = 80               # a synthetic video's frames
VIDEO_SIZE = (256, 340)         # its frames' (h, w), Kinetics' short side
VIDEO_TEST_VIDEOS = 2           # ThreeCrop test videos (6 folded clips)
MM_CLIPS = dict(RGB=(8, 224), Pose=(32, 56))   # frames, size a modality
SLOWFAST_CLIP = (32, 224)       # SlowFast's frames and crop
# pyskl's configs/posec3d/x3d_shallow_ntu60_xsub/joint.py and
# c3d_light_ntu60_xsub/joint.py, the head widths as there
X3D_SHALLOW = dict(
    type="Recognizer3D",
    backbone=dict(type="X3D", gamma_d=1, in_channels=17, base_channels=24,
                  num_stages=3, se_ratio=None, use_swish=False,
                  stage_blocks=[2, 5, 3], spatial_strides=[2, 2, 2]),
    cls_head=dict(type="I3DHead", in_channels=216, num_classes=60,
                  dropout=0.5))
C3D_LIGHT = dict(
    type="Recognizer3D",
    backbone=dict(type="C3D", in_channels=17, base_channels=32,
                  num_stages=3, temporal_downsample=False),
    cls_head=dict(type="I3DHead", in_channels=256, num_classes=60,
                  dropout=0.5))
# JAX's RGBPoseConv3D (fixed widths) with RGBPoseHead, SlowFast at JAX's
# defaults with its 2304-wide head, PoTion at its default widths over
# Heatmap2Potion(C=3, 'full') images of 17 joints (119 channels)
RGBPOSE = dict(type="MMRecognizer3D", backbone=dict(type="RGBPoseConv3D"),
               cls_head=dict(type="RGBPoseHead", num_classes=60,
                             in_channels=[2048, 512]))
SLOWFAST = dict(type="Recognizer3D",
                backbone=dict(type="ResNet3dSlowFast"),
                cls_head=dict(type="SlowFastHead", num_classes=60,
                              in_channels=2304))
POTION = dict(type="Recognizer2D",
              backbone=dict(type="PoTion", in_channels=119),
              cls_head=dict(type="TSNHead", num_classes=60,
                            in_channels=512))
IMAGENET_MEAN = [123.675, 116.28, 103.53]
IMAGENET_STD = [58.395, 57.12, 57.375]


def video_model(cfg, seed, dev):
    """``build_model`` on ``cfg`` with weights from ``init_weights_``
    (seeded), on ``dev``."""
    from dsgcn_tpu_torch.models.builder import build_model, init_weights_
    model = build_model(cfg)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def video_logits_check(name, model, batch, card, out, n_cpu=1):
    """The served (eval, BatchNorm statistics from data) model's logits on
    ``batch`` on the card, against a CPU copy's on the first ``n_cpu``
    samples: within 1e-3 of the largest card logit; so that the comparison
    can tell samples and classes apart, the card's logits must vary over
    the samples and over the classes by at least 1e-2 of the largest (ten
    times the tolerance), each stream's."""
    xs = model_inputs(batch)
    with torch.inference_mode():
        g = scores_of(model(*xs))
        c = scores_of(copy.deepcopy(model).cpu()(
            *[x[:n_cpu].cpu() for x in xs]))
    rows = {}
    for k in g:
        gk = g[k].float().cpu()
        check(gk.shape == (xs[0].shape[0], 60)
              and bool(torch.isfinite(gk).all()),
              f"{name} {k} logits of shape {tuple(gk.shape)} or not finite")
        err = rel_err(gk[:n_cpu], c[k])
        top = gk.abs().max()
        over_s = (gk.std(dim=0).mean() / top).item()
        over_c = (gk.std(dim=1).mean() / top).item()
        rows[k] = dict(rel_err=err, largest=top.item(),
                       spread_over_samples=over_s,
                       spread_over_classes=over_c)
        print(f"{name}: {'' if k == 'logits' else k + ' '}logits of "
              f"{xs[0].shape[0]} samples, card against CPU on {n_cpu}: "
              f"{err:.3e} of the largest ({top.item():.4g}); spread over "
              f"samples {over_s:.3e}, over classes {over_c:.3e}, on {card}",
              flush=True)
        check(err <= 1e-3, f"{name}: {k} GPU logits off the CPU's by "
              f"{err:.3e} of the largest")
        check(over_s >= 1e-2 and over_c >= 1e-2,
              f"{name}: {k} logits spread {over_s:.3e} over samples and "
              f"{over_c:.3e} over classes of the largest, under 1e-2")
    out["logits"] = rows


def mm_step(model, opt, sched, batch):
    """One step of MMRecognizer3D on ``mm_cross_entropy`` (JAX has no
    trainer for it: the step is written here as ``train_step`` does its
    own); ``train_step``'s ``loss`` metric."""
    from dsgcn_tpu_torch.core.losses import mm_cross_entropy
    from dsgcn_tpu_torch.core.train import zero_missing_grads_
    model.train()
    d = next(model.parameters()).device
    xs = [x.to(d) for x in model_inputs(batch)]
    loss, _ = mm_cross_entropy(model(*xs),
                               torch.as_tensor(batch["label"]).to(d))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    zero_missing_grads_(opt)
    opt.step()
    sched.step()
    return dict(loss=loss.detach())


def video_step_check(name, model, batch, step, out):
    """``gpu_vs_cpu_step`` on a float64 copy of the model (dropout off)
    and the batch's first sample (float64: phases 22-24 found float32's
    rounding through untrained BatchNorm stacks move single BatchNorm
    updates by ~1% of cosine)."""
    probe = copy.deepcopy(model).double()
    for m in probe.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    one = {k: v[:1].cpu() if k == "label" else v[:1].cpu().double()
           for k, v in batch.items()}
    print(f"{name}: a float64 step on one sample, card against CPU",
          flush=True)
    t0 = time.perf_counter()
    gpu_vs_cpu_step(probe, one, out, step)
    out["gpu_vs_cpu"]["seconds"] = time.perf_counter() - t0
    del probe


def video_timed(name, model, batch, step, card, out):
    """The served batch forward (``forward_ms``: ms, clips/s, peak GiB, no
    launch of the port's kernels), then f32 steps on the batch (dropout
    0.5 from a generator on the card; the median of VIDEO_STEPS after a
    warm-up, clips/s, peak GiB) and one more step under the profiler (the
    card's activity only: busy and idle, the top device operations)."""
    from torch.profiler import ProfilerActivity, profile

    from dsgcn_tpu_torch.core.train import make_optimizer
    from dsgcn_tpu_torch.models.builder import set_dropout_generator
    xs = model_inputs(batch)
    n = xs[0].shape[0]
    model.eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, counts = forward_ms(model, xs, iters=3)
    expect_counts(counts, {}, 1, f"{name}'s batch forward")
    out["forward"] = dict(batch=n, ms=ms, clips_per_s=n / ms * 1e3,
                          peak_mem_gib=torch.cuda.max_memory_allocated()
                          / 2 ** 30)
    set_dropout_generator(model, torch.Generator(device=xs[0].device)
                          .manual_seed(25))
    opt, sched = make_optimizer(model, 100)
    rows = []
    for i in range(1 + VIDEO_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step(model, opt, sched, batch)["loss"].item()
        wall = (time.perf_counter() - t0) * 1e3
        check(np.isfinite(loss), f"{name} step {i}: loss {loss}")
        rows.append(dict(step=i, warmup=i == 0, loss=loss, wall_ms=wall,
                         peak_mem_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30))
    timed = [r["wall_ms"] for r in rows[1:]]
    step_ms = float(np.median(timed))
    peak = max(r["peak_mem_gib"] for r in rows)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt, sched, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["train"] = dict(steps=rows, median_step_ms=step_ms,
                        clips_per_s=n / step_ms * 1e3, peak_mem_gib=peak,
                        profile=device_rows(prof, wall,
                                            f"{name} train profile f32"))
    print(f"{name}: eval forward of {n} clips {ms:.2f} ms "
          f"({n / ms * 1e3:.1f} clips/s, peak "
          f"{out['forward']['peak_mem_gib']:.2f} GiB); f32 steps at b{n} "
          f"{', '.join(f'{t:.2f}' for t in timed)} ms, median "
          f"{step_ms:.2f} ms ({n / step_ms * 1e3:.1f} clips/s), peak "
          f"{peak:.2f} GiB (TF32 off) on {card}", flush=True)
    del opt, sched


def synthetic_video(rng, n_frames, size=VIDEO_SIZE):
    """(n_frames, h, w, 3) uint8 frames that differ from video to video: a
    coarse random colour field, upsampled, drifting a few pixels a frame,
    with noise."""
    h, w = size
    coarse = rng.integers(0, 256, (6, 8, 3)).astype(np.float32)
    field = np.repeat(np.repeat(coarse, -(-h // 6), 0), -(-w // 8), 1)
    field = np.tile(field, (1, 2, 1))[:h]
    step = int(rng.integers(1, 5))
    frames = np.stack([field[:, (t * step) % w:(t * step) % w + w]
                       for t in range(n_frames)])
    noise = rng.integers(-20, 21, frames.shape)
    return np.clip(frames + noise, 0, 255).astype(np.uint8)


def mm_batch(seed, n):
    """``n`` samples of synthetic hrnet annos (COCO, 48 frames, two
    persons) with a seeded uint8 frame ``array`` (270 x 480, so MMDecode
    rescales the 1080 x 1920 keypoints), through the multimodal pipeline
    at full size (``MM_CLIPS``): MMUniformSampleFrames (RGB 8, Pose 32)
    -> MMDecode ->
    MMCompact -> Resize 224 -> Rename -> Resize 56 -> GeneratePoseTarget
    -> FormatShape; the RGB frames normalized by ImageNet's mean and std
    (``Normalize`` refuses the multimodal list modality, in JAX and here).
    Returns (imgs (n, 8, 224, 224, 3), heatmaps (n, 32, 56, 56, 17),
    labels) and the pipeline's seconds a sample."""
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    (tr, sr), (tp, sp) = MM_CLIPS["RGB"], MM_CLIPS["Pose"]
    pipeline = build_pipeline([
        dict(type="MMUniformSampleFrames", clip_len=dict(RGB=tr, Pose=tp),
             num_clips=1),
        dict(type="MMDecode"),
        dict(type="MMCompact", padding=0.25, hw_ratio=1),
        dict(type="Resize", scale=(sr, sr), keep_ratio=False),
        dict(type="Rename", mapping=dict(imgs="rgb_imgs")),
        dict(type="Resize", scale=(sp, sp), keep_ratio=False),
        dict(type="GeneratePoseTarget", sigma=0.6, use_score=True,
             with_kp=True),
        dict(type="FormatShape", input_format="NCTHW"),
    ])
    annos = make_synthetic_pose_dataset(num_samples=n, num_classes=60, t=48,
                                        seed=seed,
                                        layout="coco")["annotations"]
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    imgs, heat, labels = [], [], []
    for i, a in enumerate(annos):
        a = dict(a, array=synthetic_video(rng, 48, (270, 480)),
                 modality="Pose", start_index=0)
        r = pipeline(a, rng=np.random.RandomState(seed + i))
        rgb = (np.stack(r["rgb_imgs"]).astype(np.float32)
               - np.float32(IMAGENET_MEAN)) / np.float32(IMAGENET_STD)
        imgs.append(rgb)
        heat.append(r["imgs"])
        labels.append(r["label"])
    secs = (time.perf_counter() - t0) / n
    return (np.stack(imgs), np.stack(heat), np.array(labels)), secs


def rgbpose_part(dev, card, out):
    """RGBPoseConv3D + RGBPoseHead at full width: b8 from the multimodal
    pipeline, BatchNorm statistics from it, GPU logits against the CPU,
    a ``mm_cross_entropy`` step against the CPU, the timed forward and
    steps."""
    (imgs, heat, labels), secs = mm_batch(25, VIDEO_BATCH)
    (tr, sr), (tp, sp) = MM_CLIPS["RGB"], MM_CLIPS["Pose"]
    check(imgs.shape == (VIDEO_BATCH, tr, sr, sr, 3)
          and heat.shape == (VIDEO_BATCH, tp, sp, sp, 17)
          and 0.5 < float(heat.max()) <= 1.0,
          f"multimodal batch {imgs.shape} {heat.shape}")
    out["host_s_per_sample"] = secs
    model = video_model(RGBPOSE, 25, dev)
    out["parameters"] = sum(p.numel() for p in model.parameters())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("imgs", imgs), ("heatmap_imgs", heat), ("label", labels))}
    calibrate_posec3d_(model, *model_inputs(batch))
    video_logits_check("rgbpose", model, batch, card, out)
    video_step_check("rgbpose", model, batch, mm_step, out)
    video_timed("rgbpose", model, batch, mm_step, card, out)
    no_launches("phase 25 RGB+pose")
    del model, batch
    torch.cuda.empty_cache()


def video_dir(tmp, n_train, n_test, seed):
    """JPEG frames of ``n_train + n_test`` synthetic videos under ``tmp``
    and two rawframe annotation files ('<frame_dir> <frames> <label>')."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    lines = []
    for v in range(n_train + n_test):
        d = tmp / f"video{v:02d}"
        d.mkdir()
        for i, f in enumerate(synthetic_video(rng, VIDEO_FRAMES)):
            Image.fromarray(f).save(d / f"img_{i:05}.jpg", quality=90)
        lines.append(f"{d.name} {VIDEO_FRAMES} {int(rng.integers(60))}\n")
    (tmp / "train.txt").write_text("".join(lines[:n_train]))
    (tmp / "test.txt").write_text("".join(lines[n_train:]))


def slowfast_part(dev, card, out, tmp):
    """SlowFast-R50 (JAX's defaults) over 32 frames at 224
    (``SLOWFAST_CLIP``): VideoDataset
    rawframe lines over JPEG frames, the train pipeline (SampleFrames(32,
    2), RawFrameDecode, RandomResizedCrop, Resize 224, Flip, Normalize,
    FormatShape) through the Loader at b8, the ThreeCrop test pipeline's
    (3 x 32)-frame videos folded into three clips each as the test CLI
    folds a batch's clips; BatchNorm statistics from the train batch, GPU
    logits against the CPU on the test clips, a step against the CPU, the
    timed test forward and b8 steps."""
    from dsgcn_tpu_torch.data.dataset import Loader, VideoDataset
    from dsgcn_tpu_torch.models.recognizer import average_clip
    video_dir(tmp, VIDEO_BATCH, VIDEO_TEST_VIDEOS, seed=25)
    norm = dict(type="Normalize", mean=IMAGENET_MEAN, std=IMAGENET_STD)
    t, size = SLOWFAST_CLIP
    train = VideoDataset(str(tmp / "train.txt"), [
        dict(type="SampleFrames", clip_len=t, frame_interval=2,
             num_clips=1),
        dict(type="RawFrameDecode"),
        dict(type="RandomResizedCrop"),
        dict(type="Resize", scale=(size, size), keep_ratio=False),
        dict(type="Flip", flip_ratio=0.5),
        norm, dict(type="FormatShape", input_format="NCTHW"),
        dict(type="Collect", keys=["imgs", "label"])],
        data_prefix=str(tmp) + "/")
    test = VideoDataset(str(tmp / "test.txt"), [
        dict(type="SampleFrames", clip_len=t, frame_interval=2,
             num_clips=1, test_mode=True),
        dict(type="RawFrameDecode"),
        dict(type="Resize", scale=(-1, size)),
        dict(type="ThreeCrop", crop_size=size),
        norm, dict(type="FormatShape", input_format="NCTHW"),
        dict(type="Collect", keys=["imgs", "label"])],
        data_prefix=str(tmp) + "/", test_mode=True)
    t0 = time.perf_counter()
    batch = next(Loader(train, VIDEO_BATCH, seed=25).epoch(0))
    out["host_s_per_clip"] = (time.perf_counter() - t0) / VIDEO_BATCH
    tb = next(Loader(test, VIDEO_TEST_VIDEOS, shuffle=False).epoch(0))
    check(batch["imgs"].shape == (VIDEO_BATCH, t, size, size, 3)
          and tb["imgs"].shape == (VIDEO_TEST_VIDEOS, 3 * t, size, size,
                                   3),
          f"video batches {batch['imgs'].shape} {tb['imgs'].shape}")
    from dsgcn_tpu_torch.core.train import train_step
    model = video_model(SLOWFAST, 26, dev)
    out["parameters"] = sum(p.numel() for p in model.parameters())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    calibrate_posec3d_(model, batch["imgs"])
    # the test CLI's fold: (N, nc, T, H, W, C) -> (N nc, T, H, W, C)
    n = VIDEO_TEST_VIDEOS
    folded = torch.from_numpy(tb["imgs"].reshape(
        (n * 3, t) + tb["imgs"].shape[2:])).to(dev)
    video_logits_check("slowfast", model, dict(imgs=folded), card, out)
    with torch.inference_mode():
        scores = average_clip(model(folded).float().reshape(n, 3, -1))
    check(scores.shape == (n, 60) and bool(torch.isfinite(scores).all())
          and torch.allclose(scores.sum(-1), torch.ones(n, device=dev)),
          f"slowfast three-crop scores {tuple(scores.shape)}")
    out["test"] = dict(videos=n, clips=3 * n,
                       forward_ms=forward_ms(model, folded, iters=3)[0])
    video_step_check("slowfast", model, batch, train_step, out)
    video_timed("slowfast", model, batch, train_step, card, out)
    no_launches("phase 25 SlowFast")
    del model, batch, folded
    torch.cuda.empty_cache()


def heatmap_batch(ann, pipeline, n):
    """The first b``n`` of the 'train' split through ``pipeline`` and the
    Loader (the trainer's ``squeeze_clip`` applied); seconds a clip."""
    from dsgcn_tpu_torch.core.trainer import squeeze_clip
    from dsgcn_tpu_torch.data.dataset import Loader, PoseDataset
    ds = PoseDataset(str(ann), pipeline, split="train")
    t0 = time.perf_counter()
    b = squeeze_clip(next(Loader(ds, n, seed=25, drop_last=True)
                          .epoch(0)))
    return b, (time.perf_counter() - t0) / n


def heatmap_part(dev, card, out, tmp):
    """X3D-shallow, C3D-light (Recognizer3D + I3DHead, 60 classes) and
    PoTion (Recognizer2D + TSNHead) over PoseC3D's train pipeline at 48 x
    56 x 56 (PoTion's with ``Heatmap2Potion(C=3, 'full')`` in place of
    ``FormatHeatmapInput``): BatchNorm statistics from the b32 batch, GPU
    logits against the CPU, a step against the CPU, timed b32 forwards and
    steps; X3D and C3D through the train CLI (two b32 steps and a
    validation); X3D's seeded model through the test CLI on two videos on
    the card, with ``--bf16`` and with ``--device cpu``."""
    from dsgcn_tpu_torch.configs.config import Config
    from dsgcn_tpu_torch.core.train import train_step
    cfg = Config.fromfile(str(POSEC3D_CONFIG))
    ann = posec3d_annos(tmp, 2 * HEATMAP_BATCH, POSEC3D_CPU_VIDEOS, seed=25)
    pipe = cfg["data"]["train"]["pipeline"]
    batch, secs = heatmap_batch(ann, pipe, HEATMAP_BATCH)
    potion_pipe = [dict(type="Heatmap2Potion", C=3, option="full")
                   if s["type"] == "FormatHeatmapInput" else s for s in pipe]
    pbatch, psecs = heatmap_batch(ann, potion_pipe, HEATMAP_BATCH)
    check(batch["imgs"].shape == (HEATMAP_BATCH, 48, 56, 56, 17)
          and pbatch["imgs"].shape == (HEATMAP_BATCH, 1, 56, 56, 119),
          f"heatmap batches {batch['imgs'].shape} {pbatch['imgs'].shape}")
    out["host_s_per_clip"] = dict(heatmap=secs, potion=psecs)
    for name, mcfg, b in (("x3d_shallow", X3D_SHALLOW, batch),
                          ("c3d_light", C3D_LIGHT, batch),
                          ("potion", POTION, pbatch)):
        o = out[name] = {}
        model = video_model(mcfg, 27, dev)
        o["parameters"] = sum(p.numel() for p in model.parameters())
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        calibrate_posec3d_(model, b["imgs"])
        video_logits_check(name, model, b, card, o)
        video_step_check(name, model, b, train_step, o)
        if name == "x3d_shallow":
            wd = tmp / "wd_x3d"
            save_checkpoint(model, wd)
        video_timed(name, model, b, train_step, card, o)
        no_launches(f"phase 25 {name}")
        del model, b
        torch.cuda.empty_cache()
        if name != "potion":
            posec3d_train_cli(tmp, ann, o, model=mcfg, tag=name)
            no_launches(f"phase 25 {name} train CLI")
    x3d_test_cli(tmp, ann, wd, card, out["x3d_shallow"])
    no_launches("phase 25 X3D test CLI")


def x3d_test_cli(tmp, ann, wd, card, out):
    """The test CLI (10-clip PoseC3D test pipeline, prob averaging) on the
    X3D-shallow checkpoint under ``wd`` for the 'cpu' split's two videos:
    on the card in f32 and with ``--bf16``, and with ``--device cpu``;
    the card's f32 scores within 1e-3 of the CPU's (of the largest) with
    top-1 equal, bf16's within 2e-3 of f32's."""
    from dsgcn_tpu_torch.tools import test as test_cli
    path = posec3d_cli_config(tmp, ann, "cpu", model=X3D_SHALLOW,
                              tag="x3d_test")
    scores = {}
    for run, extra in (("cuda", []), ("bf16", ["--bf16"]),
                       ("cpu", ["--device", "cpu"])):
        pkl = tmp / f"x3d_scores_{run}.pkl"
        t0 = time.perf_counter()
        test_cli.main([str(path), str(wd), "--out", str(pkl)] + extra)
        secs = time.perf_counter() - t0
        scores[run] = torch.from_numpy(np.asarray(load_pickle(pkl)[
            "scores"]))
        out[f"cli_{run}_s"] = secs
    g, b, c = scores["cuda"], scores["bf16"], scores["cpu"]
    check(g.shape == (POSEC3D_CPU_VIDEOS, 60)
          and bool(torch.isfinite(g).all()), f"x3d scores {g.shape}")
    err, berr = rel_err(g, c), rel_err(b, g)
    top1 = g.argmax(-1).tolist() == c.argmax(-1).tolist()
    out.update(test_cli_rel_err=err, test_cli_bf16_rel_err=berr,
               test_cli_top1_equal=top1)
    print(f"x3d_shallow: test CLI on {POSEC3D_CPU_VIDEOS} videos x 10 "
          f"clips, card against CPU {err:.3e}, bf16 against f32 "
          f"{berr:.3e}, top-1 equal {top1} on {card}", flush=True)
    check(err <= 1e-3 and top1, f"x3d: GPU scores off the CPU's by "
          f"{err:.3e} (top-1 equal {top1})")
    check(berr <= 2e-3, f"x3d: bf16 scores off f32's by {berr:.3e}")


def video_phase(dev, card, report):
    """Phase 25: the 3D-CNN, video and multimodal models at full width,
    each built through ``build_model`` from a config written here, with
    seeded weights and BatchNorm statistics from its own batch (one
    train-mode forward, ``calibrate_posec3d_``): (1) RGBPoseConv3D +
    RGBPoseHead on the multimodal pipeline (``rgbpose_part``), (2)
    X3D-shallow, C3D-light and PoTion over heatmaps (``heatmap_part``),
    (3) SlowFast-R50 over JPEG frames through VideoDataset
    (``slowfast_part``).  No kernel of the port may launch."""
    import tempfile
    out = report["video"] = {}
    t_phase = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = pathlib.Path(tmp_s)
        for name, part in (("rgbpose", lambda o: rgbpose_part(dev, card, o)),
                           ("heatmap", lambda o: heatmap_part(dev, card, o,
                                                              tmp)),
                           ("slowfast", lambda o: slowfast_part(
                               dev, card, o, tmp))):
            t0 = time.perf_counter()
            part(out.setdefault(name, {}))
            out[name]["seconds"] = time.perf_counter() - t0
    counts = read_counts()
    expect_counts(counts, {}, 1, "phase 25's steps and forwards")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 25: the video and multimodal models launched no kernel "
          f"of the port: {json.dumps(counts)}; {out['seconds']:.1f} s",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dsgcn_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import argparse
    ap = argparse.ArgumentParser(description="GPU smoke run of the port")
    ap.add_argument("--sweep", action="store_true",
                    help="time K1 and K3 under the plans near their "
                    "planner's, and nothing else")
    ap.add_argument("--sweep-blocks", action="store_true",
                    help="time K5 and K6 under every plan that fits at the "
                    "main paths' shapes, and K7 under the plans next to its "
                    "planner's, and nothing else")
    ap.add_argument("--blocks", action="store_true",
                    help="phase 8's K5 and K6 checks and times, the GCN "
                    "block times and phase 11's K7 checks and times, and "
                    "nothing else")
    ap.add_argument("--every-config", action="store_true",
                    help="phase 15 alone: K1-K3 at V = 17, the four NTU "
                    "streams through the CLIs, COCO serving and training")
    ap.add_argument("--families", action="store_true",
                    help="phase 16 alone: AAGCN and CTR-GCN serving (NTU "
                    "and hrnet), training and the CLIs")
    ap.add_argument("--options", action="store_true",
                    help="phase 17 alone: the gesture and STGCN-family "
                    "hrnet configs (K7 at V = 21 and 17), the train CLI "
                    "without --validate, DGMSTCN's eval layouts, remat, "
                    "target_specific, ada_attention and per-frame graphs")
    ap.add_argument("--serving", action="store_true",
                    help="phase 18 alone: serving export and artifacts, "
                    "joint-padded mode, the pyskl import")
    ap.add_argument("--serve-artifacts", metavar="DIR",
                    help="phase 18's serving process: serve the artifacts "
                    "under DIR (no kernel build, no other phase)")
    ap.add_argument("--parallel", action="store_true",
                    help="phase 19 alone: DDP over NCCL (world 1) and over "
                    "gloo (two processes on the card), the joint partition "
                    "at G = 1")
    ap.add_argument("--extras", action="store_true",
                    help="phase 20 alone: the author's temporal MLPs and "
                    "DGHGCN (serving, steps, the pyskl round trip), feature "
                    "extraction through the test CLI, the host data path")
    ap.add_argument("--other-families", action="store_true",
                    help="phase 21 alone: MS-G3D, SGN, GTGCN, STGIN, "
                    "STGCN_GC, GCGCN and GCGCN_component (serving, GPU "
                    "against CPU, batch forwards, steps)")
    ap.add_argument("--posec3d", action="store_true",
                    help="phase 22 alone: PoseC3D (SlowOnly-R50 over "
                    "heatmap volumes) training steps and 10-clip serving "
                    "through the test CLI, GPU against CPU")
    ap.add_argument("--readouts", action="store_true",
                    help="phase 23 alone: DS-GCN with a readout neck "
                    "(serving with K3, train, gcnr and pretraining steps with "
                    "K1 + K2), SparseSTGCN, SparseCTRGCN and "
                    "SparseSTGCNExact steps, GPU against CPU")
    ap.add_argument("--smoe", action="store_true",
                    help="phase 24 alone: SparseAAGCN, SparseDGSTGCN and "
                    "AssembleSparse steps, the SMoE recognizer's steps and "
                    "forward, expert parallelism over two gloo processes")
    ap.add_argument("--video", action="store_true",
                    help="phase 25 alone: RGBPoseConv3D on the multimodal "
                    "pipeline, X3D-shallow, C3D-light and PoTion over "
                    "heatmaps, SlowFast over JPEG frames (serving, steps, "
                    "GPU against CPU, the CLIs)")
    ap.add_argument("--kernel-seeds", type=int, metavar="N",
                    help="phases 2, 6, 8 and 15(a) (the kernel checks, on "
                    "the whole run's inputs), then K4's bfloat16 cases over "
                    "N more input draws")
    ap.add_argument("--parallel-worker", metavar="PART",
                    help="one process of a phase 19 or 24 launch (nccl, "
                    "single, gloo, send or ep); no kernel build, no other "
                    "phase")
    ap.add_argument("--work", metavar="DIR",
                    help="phase 19's working directory (with "
                    "--parallel-worker)")
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout of the port (a git archive of "
                    "the parent commit): time its K5, K6 and K7 beside "
                    "these")
    args = ap.parse_args()
    if args.parallel_worker:
        parallel_worker(args.parallel_worker, args.work)
        return 0
    if args.serve_artifacts:
        serve_artifacts(args.serve_artifacts)
        return 0
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

    sass = sass_mma()
    parent = parent_wrappers(args.parent) if args.parent else None
    if args.blocks:
        report = dict(card=card, sass_mma=sass)
        dg_kernel_checks(dev, torch.Generator(device=dev).manual_seed(0),
                         report, parent, k56_only=True)
        k7_checks(dev, report, parent)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "blocks.json").write_text(json.dumps(report, indent=1,
                                                    default=sorted))
        print(card)
        return 0
    if args.sweep_blocks:
        rows = block_sweep(dev)
        k7_rows = k7_sweep(dev)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "block_sweep.json").write_text(json.dumps(
            dict(card=card, rows=rows, k7_rows=k7_rows), indent=1))
        for what, rs in (("K5/K6", rows), ("K7", k7_rows)):
            regret = [r["plan_over_best"] for r in rs]
            print(f"{card}: {what} planner's plan over the best swept plan: "
                  f"max {max(regret):.4f}, mean {np.mean(regret):.4f} over "
                  f"{len(rs)} shapes")
        return 0
    if args.sweep:
        rows = plan_sweep(dev)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "agg_sweep.json").write_text(json.dumps(
            dict(card=card, rows=rows), indent=1))
        regret = [r["plan_over_best"] for r in rows]
        print(f"{card}: planner's plan over the best swept plan: max "
              f"{max(regret):.4f}, mean {np.mean(regret):.4f} over "
              f"{len(rows)} shapes")
        return 0

    report = dict(card=card, kernel_checks=[], k2_checks=[],
                  dg_k2_checks=[], serving=[], throughput={}, profile={},
                  sass_mma=sass)
    rng = torch.Generator(device=dev).manual_seed(0)   # kernel checks' inputs
    t_run = time.perf_counter()

    def done(phase):
        at = report.setdefault("phase_done_s", {})[str(phase)] = (
            time.perf_counter() - t_run)
        print(f"phase {phase} done at {at:.1f} s", flush=True)
    if args.kernel_seeds:
        kernel_checks(dev, rng, report)
        done(2)
        k2_checks(dev, rng, report)
        done(6)
        dg_kernel_checks(dev, rng, report)
        done(8)
        coco_kernel_checks(dev, rng, report)
        done("15(a)")
        k4_seeds(dev, args.kernel_seeds, report)
        done("K4 seeds")
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "kernel_seeds.json").write_text(json.dumps(
            report, indent=1, default=str))
        print(card)
        return 0
    if args.every_config:
        every_config(dev, card, rng, report)
        done(15)
        print(card)
        return 0
    if args.options:
        options_phase(dev, card, report)
        done(17)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "options.json").write_text(json.dumps(report, indent=1,
                                                     default=str))
        print(card)
        return 0
    if args.serving:
        serving_phase(dev, card, report)
        done(18)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "serving.json").write_text(json.dumps(report, indent=1,
                                                     default=str))
        print(card)
        return 0
    if args.parallel:
        parallel_phase(dev, card, report, send_probe=True)
        done(19)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "parallel.json").write_text(json.dumps(report, indent=1,
                                                      default=str))
        print(card)
        return 0
    if args.extras:
        extras_phase(dev, card, report)
        done(20)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "extras.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
        print(card)
        return 0
    if args.other_families:
        other_families(dev, card, report)
        done(21)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "other_families.json").write_text(json.dumps(
            report, indent=1, default=str))
        print(card)
        return 0
    if args.posec3d:
        posec3d_phase(dev, card, report)
        done(22)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "posec3d.json").write_text(json.dumps(report, indent=1,
                                                     default=str))
        print(card)
        return 0
    if args.readouts:
        readouts_phase(dev, card, report)
        done(23)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "readouts.json").write_text(json.dumps(report, indent=1,
                                                      default=str))
        print(card)
        return 0
    if args.smoe:
        smoe_phase(dev, card, report)
        done(24)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "smoe.json").write_text(json.dumps(report, indent=1,
                                                  default=str))
        print(card)
        return 0
    if args.video:
        video_phase(dev, card, report)
        done(25)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "video.json").write_text(json.dumps(report, indent=1,
                                                   default=str))
        print(card)
        return 0
    if args.families:
        families(dev, card, report)
        done(16)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "families.json").write_text(json.dumps(report, indent=1,
                                                      default=str))
        print(card)
        return 0
    worst, per_forward = kernel_checks(dev, rng, report)          # phase 2
    done(2)
    model, bf16, main_counts, fused_counts = serve(dev, report)   # 3-4
    throughput(model, bf16, dev, card, report)                     # 5
    del model, bf16
    done("3-5")
    worst_t, per_step = k2_checks(dev, rng, report)               # 6
    done(6)
    dg_worst, dg_fwd, dg_worst_t, dg_step = dg_kernel_checks(     # 8
        dev, rng, report, parent)
    done(8)
    dg_auto, dg_options = serve_dgstgcn(dev, card, report)        # 9
    done(9)
    k7_worst, k7_fwd = k7_checks(dev, report, parent)              # 11
    done(11)
    stgcnpp_counts = serve_stgcnpp(dev, card, report)              # 12
    serve_with_k7(dev, card, report)                               # 13
    done("12-13")
    train_counts = train(dev, card, report)                        # 7, 10
    done("7, 10")
    train_stgcnpp(dev, card, report)                               # 14
    done(14)
    v17_worst, v17_sums, coco_serve_counts, coco_train_counts = \
        every_config(dev, card, rng, report)                      # 15
    done(15)
    families(dev, card, report)                                    # 16
    done(16)
    k7_joints = options_phase(dev, card, report)                   # 17
    done(17)
    serving_phase(dev, card, report)                               # 18
    done(18)
    parallel_phase(dev, card, report)                              # 19
    done(19)
    extras_phase(dev, card, report)                                # 20
    done(20)
    other_families(dev, card, report)                              # 21
    done(21)
    posec3d_phase(dev, card, report)                               # 22
    done(22)
    readouts_phase(dev, card, report)                              # 23
    done(23)
    smoe_phase(dev, card, report)                                  # 24
    done(24)
    video_phase(dev, card, report)                                 # 25
    done(25)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "posec3d.json").write_text(json.dumps(report["posec3d"], indent=1,
                                                 default=str))
    (out / "readouts.json").write_text(json.dumps(report["readouts"],
                                                  indent=1, default=str))
    (out / "smoe.json").write_text(json.dumps(report["smoe"], indent=1,
                                              default=str))
    (out / "video.json").write_text(json.dumps(report["video"], indent=1,
                                               default=str))

    # K1 and K2 on DS-GCN's training path (times per step at b128 x M2 x
    # T60), K3 on DS-GCN's serving path and K4 on DG-STGCN's (times per
    # forward at b64 x M2 x T100), K5 and K6 on DG-STGCN's 'fusedpre' and
    # 'mega' serving paths, K7 on STGCN++'s (per forward, beside it the
    # unfused region's time); errors over every check of the kernel
    sources = [
        ("bd_dyn_graph_agg", "bd_agg.cu", "bd_agg.py:170", main_counts,
         per_forward),
        ("fused_dyn_graph_agg", "dyn_graph.cu", "dyn_graph.py:232",
         train_counts, per_step),
        ("fused_dyn_graph_agg_bwd", "dyn_graph_bwd.cu", "dyn_graph.py:511",
         train_counts, per_step),
        ("bd_dyn_graph_agg_subset", "bd_agg.cu", "bd_agg.py:244",
         dg_auto, dg_fwd),
        ("fused_dyn_graph_agg_eval", "dyn_graph_eval.cu", "dyn_graph.py:655",
         dg_options["fusedpre"], dg_fwd),
        ("fused_dggcn_block_eval", "dggcn_block.cu", "dggcn_block.py:141",
         dg_options["mega"], dg_fwd),
        ("fused_dgmstcn_eval", "ms_tcn.cu", "ms_tcn.py:156", stgcnpp_counts,
         {"fused_dgmstcn_eval": k7_fwd["stgcnpp"]}),
    ]
    worst_all = (worst, worst_t, dg_worst, dg_worst_t,
                 {"fused_dgmstcn_eval": max(
                     [k7_worst] + [v[0] for v in k7_joints.values()])},
                 v17_worst)
    # K3 per COCO forward and K1, K2 per COCO step at b32 x M2 x T100 (V =
    # 17), with their launches on phase 15's serving and training paths
    v17_counts = {"bd_dyn_graph_agg": coco_serve_counts,
                  "fused_dyn_graph_agg": coco_train_counts,
                  "fused_dyn_graph_agg_bwd": coco_train_counts}
    kernels = []
    for name, src, replaces, counts, times in sources:
        pf = times[name]
        check(counts[name] > 0, f"{name} was never launched on its path")
        err = max(w.get(name, 0.0) for w in worst_all)
        kernels.append(dict(
            name=name, route="cuda",
            source=f"dsgcn_tpu_torch/ops/kernels/csrc/{src}",
            replaces=f"dsgcn_tpu/ops/pallas/{replaces}",
            launches=counts[name], max_abs_err=err, ms=pf["ms"],
            plain_ms=pf["plain_ms"], bound_ms=pf["bound_ms"],
            bound_by="/".join(sorted(pf["bound_by"])),
            library_ms=pf["library_ms"],
            ms_over_library=(pf["ms"] / pf["library_ms"]
                             if pf["library_ms"] else None),
            ms_over_bound=pf["ms"] / pf["bound_ms"],
            **{k: pf[k] for k in ("unfused_ms", "parent_ms") if k in pf}))
        if name in v17_counts:
            check(v17_counts[name][name] > 0,
                  f"{name} was never launched on the COCO path")
            v = v17_sums[COCO_N[0]][name]
            kernels[-1]["v17"] = dict(
                N=COCO_N[0], launches=v17_counts[name][name], ms=v["ms"],
                plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                bound_by="/".join(sorted(v["bound_by"])),
                library_ms=v["library_ms"], max_abs_err=v17_worst[name])
        if name == "fused_dgmstcn_eval":
            # K7 per forward of the gesture model (V = 21, b64 x M1 x T10)
            # and of STGCN++ on hrnet (V = 17, b64 x M2 x T100), with the
            # launches of their serving paths
            for key, (err, v, counts, n) in k7_joints.items():
                check(counts[name] > 0,
                      f"{name} was never launched on the {key} path")
                kernels[-1][key] = dict(
                    N=n, launches=counts[name], ms=v["ms"],
                    plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                    bound_by="/".join(sorted(v["bound_by"])),
                    library_ms=None, unfused_ms=v["unfused_ms"],
                    max_abs_err=err)
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
