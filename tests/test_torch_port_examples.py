"""The port's examples on the CPU.

``examples/torch_imagenet_resnet50.py``, the counterpart of
``examples/jax_imagenet_resnet50.py``, in a gloo world of two as
tests/test_resume_example.py drives the reference's: stop after epoch 2,
relaunch, resume from the epoch-2 checkpoint. Loss continuity is held as
equality: epochs 3 and 4 of the resumed run print the losses of a run
that never stopped, since the restore puts every parameter, momentum
buffer and BatchNorm statistic back and each step's batch depends only
on (seed, epoch, step, rank). It runs at its default image size, 32: at
8 and 16 PyTorch's CPU bf16 convolution backward returns run-to-run
different weight gradients for ResNet-18's last stride-2 convolution on a
1 x 1 input, so no two runs there agree, stopped or not.

The port of ``examples/transformer_benchmark.py``,
``python -m horovod_tpu_torch.transformer_benchmark``, end to end on the
CPU at the reference test's tiny size (tests/test_examples.py:102: dim 32,
4 heads over 2 kv heads, 2 layers, vocab 64, T 64), with the reference's
variants: the full logits, remat with the chunked loss, the bf16 head and
K steps per dispatch. Its FLOP count and its median-window timing are
copies of the JAX package's, held against them.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu_torch import transformer_benchmark as tb
from launch_util import REPO, free_port

SMALL = ["--dim", "32", "--heads", "4", "--kv-heads", "2", "--layers", "2",
         "--vocab", "64", "--seq-len", "64", "--num-warmup", "1",
         "--num-iters", "2"]


def _run(extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT", "HOROVOD_COORD_ADDR"):
        env.pop(var, None)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.transformer_benchmark",
         "--device", "cpu", *SMALL, *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


@pytest.mark.parametrize("extra", [
    [], ["--remat", "--loss-chunk", "16"], ["--bf16-logits"],
    ["--scan-steps", "2"]],
    ids=["full-logits", "remat-chunked", "bf16-logits", "scan-steps"])
def test_transformer_benchmark_on_the_cpu(extra):
    proc = _run([*extra, "--json"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Tokens/sec on 1 device(s)" in proc.stdout
    assert "kv 2" in proc.stdout
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "torch_transformer_tokens_per_sec"
    assert line["value"] > 0 and line["unit"] == "tok/s"
    assert line["device"] == "cpu" and line["mfu"] is None
    assert line["remat"] == ("--remat" in extra)
    assert line["bf16_logits"] == ("--bf16-logits" in extra)
    assert line["scan_steps"] == (2 if "--scan-steps" in extra else 1)
    assert 0 < line["loss"] < 10


def test_transformer_benchmark_rejects_a_bf16_head_with_a_chunked_loss():
    proc = _run(["--bf16-logits", "--loss-chunk", "16"])
    assert proc.returncode == 2
    assert "does not reach the --loss-chunk path" in proc.stderr


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_transformer_benchmark",
        os.path.join(REPO, "examples", "transformer_benchmark.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("argv", [
    [], ["--kv-heads", "2", "--seq-len", "32768"],
    ["--dim", "512", "--heads", "4", "--layers", "3", "--vocab", "1000"]])
def test_flops_per_token_is_the_reference_count(argv):
    ref = _reference_example()
    args = tb.parse_args(["--device", "cpu", *argv])
    assert tb.model_flops_per_token(args) == ref.model_flops_per_token(args)


def test_median_window_timing_is_the_reference_method(monkeypatch):
    """Both functions make the same calls in the same order and return
    the same rate on the same clock."""
    from horovod_tpu.jax import autotune

    rates, logs = [], []
    for module in (tb, autotune):
        ticks = iter(range(1000))
        monkeypatch.setattr(module.time, "perf_counter",
                            lambda: float(next(ticks)) ** 1.5)
        log = []
        rates.append(module.measure_steps_per_s(
            lambda: log.append("step"), warmup=2, iters=3, reps=3,
            sync=lambda: log.append("sync")))
        logs.append(log)
    assert rates[0] == rates[1] and logs[0] == logs[1]


RESNET_EXAMPLE = os.path.join(REPO, "examples", "torch_imagenet_resnet50.py")
RESNET_ARGS = ["--epochs", "4", "--steps-per-epoch", "2", "--batch-size", "4",
               "--device", "cpu"]


def _launch_example(args):
    """Start the example as a gloo world of two; return its processes."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
        env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, RESNET_EXAMPLE, *RESNET_ARGS, *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _records(procs):
    """Rank 0's JSON lines, once both ranks exited 0."""
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        assert proc.returncode == 0, err[-3000:]
        outs.append(out)
    assert outs[1].strip() == ""
    return [json.loads(line) for line in outs[0].splitlines() if line.startswith("{")]


def test_resnet_example_resumes_from_its_checkpoint(tmp_path):
    ckpt, straight = str(tmp_path / "ck"), str(tmp_path / "straight")
    stopped = _launch_example(["--checkpoint-dir", ckpt, "--stop-after-epoch", "2"])
    whole = _launch_example(["--checkpoint-dir", straight])
    phase1, reference = _records(stopped), _records(whole)
    assert [r["epoch"] for r in phase1 if "epoch" in r] == [1, 2]
    assert phase1[-1] == {"stopped_after_epoch": 2}
    assert sorted(os.listdir(ckpt)) == ["step_1", "step_2"]

    phase2 = _records(_launch_example(["--checkpoint-dir", ckpt]))
    assert phase2[0] == {"resumed_from": 2}
    assert [r["epoch"] for r in phase2[1:]] == [3, 4]
    losses = [r["train_loss"] for r in phase1 + phase2 if "epoch" in r]
    assert all(np.isfinite(losses))
    assert losses == [r["train_loss"] for r in reference]
    assert sorted(os.listdir(ckpt)) == ["step_1", "step_2", "step_3", "step_4"]
