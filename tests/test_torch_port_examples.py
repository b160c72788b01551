"""The port of ``examples/transformer_benchmark.py``,
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

import pytest

from horovod_tpu_torch import transformer_benchmark as tb
from launch_util import REPO

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
