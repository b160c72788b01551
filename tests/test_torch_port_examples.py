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
K steps per dispatch, and ``--profile``. Its FLOP count is a copy of the
JAX package's and its median-window timing the port's autotuner's, held
against them.

The examples ported from the JAX package's, each at the small size the
JAX example's test runs (tests/test_examples.py) and holding what that
test holds: ``torch_mnist.py`` in one process, ``torch_mnist_advanced.py``
(the warmup's lr at its end), ``torch_synthetic_benchmark.py`` (the
img/s lines) and ``torch_word2vec.py`` (its losses against
``jax_word2vec.py``'s on a world of two) in gloo worlds of two, and
``torch_transformer_long_context.py``'s ring flash against its plain ring.
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
    the same rate on the same clock; the benchmark's is the autotuner's."""
    from horovod_tpu.jax import autotune
    from horovod_tpu_torch import autotune as port_autotune

    assert tb.measure_steps_per_s is port_autotune.measure_steps_per_s
    rates, logs = [], []
    for module in (port_autotune, autotune):
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


def _launch(script, args, world=2, **env_extra):
    """Start ``script`` as a gloo world of ``world``; return its processes."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                            "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORD_ADDR")}
        if world > 1:
            env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                       HOROVOD_COORD_ADDR=f"127.0.0.1:{port}")
        env.update(OMP_NUM_THREADS="2", **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, script, *args], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _launch_example(args):
    """Start the ResNet example as a gloo world of two."""
    return _launch(RESNET_EXAMPLE, [*RESNET_ARGS, *args])


def _outputs(procs):
    """Every rank's stdout, once all exited 0; only rank 0 prints."""
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        assert proc.returncode == 0, err[-3000:]
        outs.append(out)
    assert all(out.strip() == "" for out in outs[1:])
    return outs[0]


def _records(procs):
    """Rank 0's JSON lines, once both ranks exited 0."""
    return [json.loads(line) for line in _outputs(procs).splitlines()
            if line.startswith("{")]


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


# ------------------------------------------------------ the ported examples
# Each is the counterpart of a JAX example, at the small size the JAX
# example's test runs (tests/test_examples.py), and holds what that test
# holds.

def _example(name):
    return os.path.join(REPO, "examples", name)


def test_torch_mnist_example_single():
    out = _outputs(_launch(_example("torch_mnist.py"), ["--device", "cpu"],
                           world=1, MNIST_STEPS="3"))
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("epoch")]
    assert "epoch 2" in out and len(losses) == 3
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_torch_mnist_advanced_2proc():
    """The warmup ramps lr from 0.005 to 0.005 x 2 over two epochs, as the
    JAX example's test holds, and the epoch-end metrics are averaged."""
    out = _outputs(_launch(_example("torch_mnist_advanced.py"),
                           ["--device", "cpu"], MNIST_EPOCHS="3",
                           MNIST_STEPS="4"))
    assert "epoch 2" in out
    assert "averaged over 2 ranks" in out
    assert "lr 0.0100" in out and "lr 0.0050" not in out.splitlines()[-1]


def test_torch_synthetic_benchmark_2proc():
    out = _outputs(_launch(_example("torch_synthetic_benchmark.py"), [
        "--device", "cpu", "--model", "ResNet18", "--batch-size", "2",
        "--image-size", "32", "--dtype", "float32", "--num-iters", "2",
        "--num-batches-per-iter", "1", "--num-warmup-batches", "1",
        "--roofline"]))
    assert "Img/sec per device" in out
    assert "Total img/sec on 2 device(s)" in out
    assert "roofline: unavailable" in out          # no card: no device trace


W2V_ENV = dict(W2V_EPOCHS="2", W2V_STEPS="3", W2V_VOCAB="200", W2V_DIM="16",
               W2V_BATCH="32")


def _epoch_losses(out):
    return [float(line.split()[3]) for line in out.splitlines()
            if line.startswith("epoch")]


def test_torch_word2vec_matches_the_jax_example():
    """Two gloo ranks against the JAX example on two virtual devices: the
    same seed draws the same tables and batches, so every epoch's loss
    agrees to the printed digits (float32 on both sides)."""
    port = _outputs(_launch(_example("torch_word2vec.py"), ["--device", "cpu"],
                            **W2V_ENV))
    env = dict(os.environ, HVD_FORCE_CPU="1", **W2V_ENV,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORD_ADDR"):
        env.pop(var, None)
    ref = subprocess.run([sys.executable, _example("jax_word2vec.py")],
                         capture_output=True, text=True, timeout=300, cwd=REPO,
                         env=env)
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert "sparse rows/step: 448" in port and "sparse rows/step: 448" in ref.stdout
    got, want = _epoch_losses(port), _epoch_losses(ref.stdout)
    assert len(got) == 2 and np.allclose(got, want, rtol=0, atol=2e-4), (got, want)


def test_torch_long_context_ring_flash_matches_the_plain_ring():
    """dp 1 x sp 2 in float32: ring flash (the plain versions of B4-B6 on
    the CPU) against the plain ring attention, the same model and tokens,
    so every step's loss agrees to float32 rounding, and it falls. (Each
    shard's targets roll within the shard, as the JAX example's do, so a
    ring's loss is not the whole sequence's.)"""
    args = ["--device", "cpu", "--dp", "1", "--seq-len", "64", "--dim", "32",
            "--heads", "4", "--layers", "2", "--dtype", "float32", "--steps", "3"]
    script = _example("torch_transformer_long_context.py")
    flash = _outputs(_launch(script, args))
    plain = _outputs(_launch(script, args + ["--attention", "dense"]))
    assert "over 2 sequence shards" in flash

    def losses(out):
        return [float(line.split()[3]) for line in out.splitlines()
                if line.startswith("step")]

    got, want = losses(flash), losses(plain)
    assert len(got) == 3 and got[-1] < got[0]
    assert np.allclose(got, want, rtol=1e-5, atol=0), (got, want)


def test_transformer_benchmark_profile_on_the_cpu():
    proc = _run(["--profile", "--json"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "roofline: unavailable" in proc.stdout
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["peak_flops"] is None and line["mfu"] is None
