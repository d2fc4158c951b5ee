"""The port's CLIs on two processes: data-parallel training through
``dsgcn_tpu_torch.tools.train`` and distributed evaluation through
``dsgcn_tpu_torch.tools.test``, each process started with the launcher's
environment (RANK, WORLD_SIZE, LOCAL_RANK) and joined over gloo through a
``file://`` store (the counterpart of ``tests/test_multihost.py``, which
drives JAX's ``tools/train.py`` the same way).

The two processes end with the same weights (a hash of every tensor),
which holds only if gradients and BatchNorm statistics were reduced across
the processes every step; rank 0 alone writes the JSONL log (with its
``val`` records) and the checkpoints, which ``apis.init_recognizer`` loads;
a second launch resumes; and the test CLI on two processes prints the
scores of one process's run.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from dsgcn_tpu_torch.apis import init_recognizer
from dsgcn_tpu_torch.tools import test as test_cli
from test_torch_port_train import _cli_config

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_dist_worker.py")


def _start(tmp, tag, args, world=2):
    """Start ``world`` processes of the worker's CLI mode."""
    store = tmp / f"store_{tag}"
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "cli", *args, "--device", "cpu",
             "--dist-url", f"file://{store}"], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def _wait(procs):
    """The outputs of :func:`_start`'s processes, each ended with rc 0."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rc={p.returncode}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _lines(out, key):
    return [line.split(maxsplit=1)[1] for line in out.splitlines()
            if line.startswith(key)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of one epoch, a second of two (resuming), then the test
    CLI on two processes and in this one."""
    tmp = tmp_path_factory.mktemp("mp")
    cfg = tmp / "mp.py"      # the train CLI test's config, tested on val
    cfg.write_text(f"""
_base_ = [{_cli_config(tmp)!r}]
data = dict(test=dict(ann_file={str(tmp / 'synth.pkl')!r}, split='val'))
""")
    cfg = str(cfg)
    wd = tmp / "wd"
    base = [cfg, "--work-dir", str(wd), "--seed", "3"]
    first = _wait(_start(tmp, "a", base + ["--total-epochs", "1"]))
    steps_a = sorted(int(f[:-3]) for f in os.listdir(wd / "ckpt")
                     if f.endswith(".pt"))
    second = _wait(_start(tmp, "b", base + ["--total-epochs", "2"]))
    testing = _start(tmp, "c", ["test", cfg, str(wd), "--out",
                                str(tmp / "scores2.pkl")])
    # meanwhile the same test CLI in one process (no launcher)
    one = test_cli.main([cfg, str(wd), "--device", "cpu", "--out",
                         str(tmp / "scores1.pkl")])
    return dict(cfg=cfg, wd=wd, tmp=tmp, first=first, second=second,
                tested=_wait(testing), one=one, steps_a=steps_a)


def test_ranks_end_with_equal_weights(runs):
    for outs in (runs["first"], runs["second"]):
        hashes = [_lines(o, "PARAM_HASH") for o in outs]
        assert all(len(h) == 1 for h in hashes), outs
        assert hashes[0] == hashes[1]
        vals = [_lines(o, "VAL") for o in outs]
        assert vals[0] == vals[1] and "top1_acc" in vals[0][0]
    # the second launch trained on: other weights
    assert _lines(runs["first"][0], "PARAM_HASH") != \
        _lines(runs["second"][0], "PARAM_HASH")


def test_one_log_with_val_records_and_a_resume(runs):
    wd = runs["wd"]
    logs = sorted(f for f in os.listdir(wd) if f.endswith(".log.jsonl"))
    assert len(logs) == 2          # one a launch, both rank 0's
    records = [[json.loads(line) for line in (wd / f).read_text()
                .splitlines()] for f in logs]
    assert any(r.get("mode") == "val" for r in records[0])
    assert any(r.get("event") == "epoch_done" for r in records[0])
    assert records[1][0] == dict(event="resume", epoch=1,
                                 step=runs["steps_a"][-1])
    # the batch line: clips a process, and the global batch
    assert "batch: 4/device x 1 device = 4/process (8 global)" in \
        runs["first"][0]


def test_one_checkpoint_dir_loads_in_init_recognizer(runs):
    ckpt = runs["wd"] / "ckpt"
    steps = sorted(int(f[:-3]) for f in os.listdir(ckpt)
                   if f.endswith(".pt"))
    assert steps and steps[-1] == 2 * runs["steps_a"][-1]
    model = init_recognizer(runs["cfg"], str(ckpt / f"{steps[-1]}.pt"),
                            device="cpu")
    assert not any(k.startswith("module.") for k in model.state_dict())


def test_distributed_test_cli_matches_one_process(runs):
    """tools/test.py on two processes (clips wrapped to a multiple of 2,
    each process its rows, logits gathered) prints and dumps the scores
    of the same CLI in one process."""
    scores, labels = runs["one"]
    with open(runs["tmp"] / "scores2.pkl", "rb") as f:
        two = pickle.load(f)
    assert two["labels"] == labels
    np.testing.assert_allclose(two["scores"], scores, rtol=1e-6, atol=1e-7)
    printed = [line for line in runs["tested"][0].splitlines()
               if line.startswith("top1_acc")]
    assert printed == [f"top1_acc: {_top1(scores, labels):.4f}"]
    assert not runs["tested"][1].strip()     # rank 1 prints nothing


def _top1(scores, labels):
    return float(np.mean(np.argmax(scores, axis=1) == np.asarray(labels)))
