"""``horovod_tpu_torch.checkpoint`` on the CPU, against
``horovod_tpu.checkpoint``.

- The commit pipeline is a copy: ``_swap_into_place`` and
  ``_heal_interrupted`` run on the same directory layouts as the JAX
  package's and must leave the same names with the same contents;
  ``latest_step`` must give the same answer on the same directories.
  A writer SIGKILLed inside its stage window leaves the old checkpoint,
  one killed between the swap's renames leaves a stage that the next
  restore adopts: the outcomes the JAX package's own tests pin.
- Round trips are bit for bit (float32, bf16, int64, a Python int, a
  numpy scalar); restore writes into the template's tensors, whose
  ``data_ptr()`` stays. An optimizer in the template takes its state in
  place and its param groups' hyperparameters: SGD with momentum under
  ``LearningRateWarmupCallback``, stopped in the middle of the warmup and
  resumed, is bit-equal in every lr, parameter and momentum buffer to the
  run that never stopped.
- A 2-layer, dim-64, seq-128 flash TransformerLM (the plain attention on
  the CPU) trained 3 steps, saved, restored into a fresh run drawn from
  another seed and trained 3 more is bit-equal, in every loss, parameter
  and Adam moment, to the run that never stopped: the same operations on
  the same values.
- A checkpoint written by ``horovod_tpu.checkpoint.save``, restored by it
  and carried over by ``convert.py``, gives the port's forward the JAX
  model's logits within 1e-5 of their largest magnitude (JAX at
  "highest" matmul precision; float32 on both sides, the sums in another
  order).
- ``export_for_inference`` / ``load_for_inference`` in a fresh process
  that never calls ``init()``: the same logits bit for bit.
- A gloo world of two (tests/torch_port_ckpt_worker.py): the digest
  passes on the same state, raises the JAX package's message on every rank
  when rank 1 read other state, and raises within a 5 s
  ``HOROVOD_CKPT_VERIFY_TIMEOUT`` when a rank does not take part; ``save``
  returns on rank 1 only once rank 0's commit is in place;
  ``broadcast_resume_state`` keeps each leaf's type; ``save_sharded`` under
  1 x 2 holds the leaves bit-equal to the JAX package's ``unshard_tree``
  of the same state, and restores into 2 x 1, into the flat leaves and into
  1 x 2 (pad zeroed) bit for bit.
"""

import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import checkpoint as ref_ckpt
from horovod_tpu_torch import checkpoint as ck
from horovod_tpu_torch import convert
from horovod_tpu_torch.callbacks import LearningRateWarmupCallback
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.train import TrainConfig, make_batch, setup
from launch_util import REPO, free_port

WORKER = os.path.join(REPO, "tests", "torch_port_ckpt_worker.py")
ENV_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "HOROVOD_COORD_ADDR")


@pytest.fixture()
def cpu_world(monkeypatch):
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


# -- the commit pipeline, against the JAX package's -------------------------


def _fake(path, tag):
    os.makedirs(path)
    with open(os.path.join(path, "data.bin"), "w") as f:
        f.write(tag)


def _ok(path):
    with open(path + ".ok", "w") as f:
        f.write("complete\n")


def _listing(root):
    out = {}
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p):
            with open(os.path.join(p, "data.bin")) as f:
                out[name] = f.read()
        else:
            out[name] = "file"
    return out


# Each layout: the entries next to the target "ck" before the call, and the
# call (swap the stage .tmp.5 in, or heal).
LAYOUTS = {
    "swap_over_old": ({"ck": "old", "ck.tmp.5": "new"}, [], "swap"),
    "swap_no_old": ({"ck.tmp.5": "new"}, [], "swap"),
    "heal_adopts_complete_stage": ({"ck.tmp.9": "staged"}, ["ck.tmp.9"], "heal"),
    "heal_discards_torn_stage_and_trash": (
        {"ck": "good", "ck.tmp.7": "torn", "ck.trash.8": "displaced"}, [], "heal"),
    "heal_prefers_target_over_stage": ({"ck": "current", "ck.tmp.5": "stale"},
                                       ["ck.tmp.5"], "heal"),
    "heal_two_stages_one_complete": ({"ck.tmp.3": "torn", "ck.tmp.4": "staged"},
                                     ["ck.tmp.4"], "heal"),
    "heal_leaves_other_names": ({"ck": "good", "other.tmp.1": "x", "ck2": "y"},
                                [], "heal"),
    "heal_nothing_there": ({}, [], "heal"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_commit_pipeline_matches_reference(tmp_path, layout):
    entries, oks, call = LAYOUTS[layout]
    results = []
    for mod, side in ((ref_ckpt, "ref"), (ck, "port")):
        root = tmp_path / side
        root.mkdir()
        for name, tag in entries.items():
            _fake(str(root / name), tag)
        for name in oks:
            _ok(str(root / name))
        target = str(root / "ck")
        if call == "swap":
            mod._swap_into_place(target + ".tmp.5", target)
        else:
            mod._heal_interrupted(target)
        results.append(_listing(root))
    assert results[0] == results[1]


@pytest.mark.parametrize("names", [
    None, [], ["step_1", "step_5", "step_3"], ["step_9", "step_10"],
    ["step_x", "step_2", "other", "step_", "step_007"], ["step_4.tmp.12", "step_3"]],
    ids=["missing", "empty", "three", "numeric-order", "odd-names", "with-stage"])
def test_latest_step_matches_reference(tmp_path, names):
    root = tmp_path / "c"
    if names is not None:
        root.mkdir()
        for n in names:
            (root / n).mkdir()
    assert ck.latest_step(str(root)) == ref_ckpt.latest_step(str(root))


KILL_SCRIPT = """
import os, sys
sys.path.insert(0, os.environ["HVD_REPO"])
import torch
from horovod_tpu_torch import checkpoint
checkpoint.save_local(os.environ["CK_PATH"], {"w": torch.arange(4.0) * 5})
print("COMMITTED", flush=True)
"""


def _siblings(path, infix):
    parent, base = os.path.split(path)
    return [n for n in os.listdir(parent) if n.startswith(base + infix)]


def kill_in_window(script, path, point, in_window):
    """Run ``script`` with its commit held at ``point``, SIGKILL it once
    ``in_window()`` sees that window on disk, and check it died there."""
    env = dict(os.environ, HVD_REPO=REPO, CK_PATH=path,
               HOROVOD_CKPT_TEST_STALL=point, HOROVOD_CKPT_TEST_STALL_S="45")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while not in_window():
            if proc.poll() is not None:
                raise AssertionError(f"writer exited before the {point} window: "
                                     f"{proc.communicate()[1].decode()[-2000:]}")
            assert time.monotonic() < deadline, f"{point} window never appeared"
            time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == -signal.SIGKILL


def test_sigkill_in_stage_keeps_the_old_checkpoint(tmp_path):
    path = str(tmp_path / "ck")
    ck.save_local(path, {"w": torch.arange(4.0)})

    def in_stage():
        return any(not n.endswith(".ok") for n in _siblings(path, ".tmp.")) and \
            not any(n.endswith(".ok") for n in _siblings(path, ".tmp."))

    kill_in_window(KILL_SCRIPT, path, "stage", in_stage)
    ck._heal_interrupted(path)
    assert _siblings(path, ".tmp.") == [] and _siblings(path, ".trash.") == []
    got = ck.restore(path, template={"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4.0))


def test_sigkill_between_renames_adopts_the_stage(tmp_path):
    path = str(tmp_path / "ck")
    ck.save_local(path, {"w": torch.arange(4.0)})

    def in_rename():
        return bool(_siblings(path, ".trash.")) and not os.path.exists(path)

    kill_in_window(KILL_SCRIPT, path, "rename", in_rename)
    assert not os.path.exists(path)
    got = ck.restore(path, template={"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4.0) * 5)
    assert sorted(os.listdir(tmp_path)) == ["ck"]


# -- round trips ----------------------------------------------------------------


def _state():
    rng = np.random.default_rng(5)
    return {"f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
            "bf16": torch.from_numpy(rng.standard_normal(7).astype(np.float32)
                                     ).to(torch.bfloat16),
            "i64": torch.from_numpy(rng.integers(-2**40, 2**40, 6)),
            "epoch": 7, "np": np.int64(-3), "view": torch.arange(10.0)[2:5]}


def test_round_trip_is_bit_equal(cpu_world, tmp_path):
    state = _state()
    ck.save(str(tmp_path / "c"), state, step=4)
    assert os.listdir(tmp_path / "c") == ["step_4"]
    assert os.listdir(tmp_path / "c" / "step_4") == [ck.STATE_FILE]
    plain = torch.load(tmp_path / "c" / "step_4" / ck.STATE_FILE, weights_only=True)
    # a view is saved alone, not with the storage it lives in
    assert plain["view"].untyped_storage().nbytes() == 3 * 4
    got = ck.restore(str(tmp_path / "c"), step=4, device="cpu")
    for k in ("f32", "bf16", "i64", "view"):
        assert got[k].dtype == state[k].dtype and torch.equal(got[k], state[k]), k
    assert got["epoch"] == 7 and type(got["epoch"]) is int
    assert got["np"].dtype == torch.int64 and got["np"].item() == -3
    tmpl = {"f32": torch.zeros(3, 5), "bf16": torch.zeros(7, dtype=torch.bfloat16),
            "i64": torch.zeros(6, dtype=torch.int64), "epoch": 0,
            "np": np.int64(0), "view": torch.zeros(3)}
    got = ck.restore(str(tmp_path / "c"), template=tmpl, step=4)
    for k in ("f32", "bf16", "i64", "view"):
        assert got[k] is tmpl[k] and torch.equal(got[k], state[k]), k
    assert got["epoch"] == 7 and got["np"] == -3 and got["np"].dtype == np.int64


def test_restore_checks_the_template_and_the_checkpoint(cpu_world, tmp_path):
    path = str(tmp_path / "c")
    ck.save(path, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="template"):
        ck.restore(path, template={"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="template"):
        ck.restore(path, template={"w": torch.zeros(2, 3, dtype=torch.float64)})
    with pytest.raises(ValueError, match="keys"):
        ck.restore(path, template={"v": torch.zeros(2, 3)})
    with pytest.raises(FileNotFoundError):
        ck.restore(path, step=3)
    with pytest.raises(TypeError, match="leaf /x"):
        ck.save(path, {"x": object()})


def test_restore_keeps_every_data_ptr(cpu_world, tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.LayerNorm(8),
                                torch.nn.Linear(8, 2))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(torch.randn(3, 4)).sum().backward()
    opt.step()
    saved = {"model": {k: v.clone() for k, v in model.state_dict().items()},
             "opt": {i: {k: v.clone() for k, v in s.items()}
                     for i, s in opt.state_dict()["state"].items()}}
    ck.save(str(tmp_path / "c"), {"model": model.state_dict(),
                                  "opt": opt.state_dict()}, step=1)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(-3.0)
        for s in opt.state.values():
            for v in s.values():
                v.add_(1.0)
    live = [t for t in model.state_dict().values()] + \
        [v for s in opt.state.values() for v in s.values()]
    ptrs = [t.data_ptr() for t in live]
    ck.restore(str(tmp_path / "c"), template={"model": model.state_dict(),
                                              "opt": opt.state_dict()}, step=1)
    assert [t.data_ptr() for t in live] == ptrs
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, saved["opt"][i][k]), (i, k)


def test_init_optimizer_state_moves_no_parameter(cpu_world):
    w = torch.nn.Parameter(torch.randn(4))
    before = w.detach().clone()
    opt = hvd.DistributedOptimizer(torch.optim.Adam([w], lr=0.1), [("w", w)])
    ck.init_optimizer_state(opt)
    st = opt.optimizer.state[w]
    assert torch.equal(w.detach(), before) and w.grad is None
    assert sorted(st) == ["exp_avg", "exp_avg_sq", "step"]
    with pytest.raises(ValueError, match="weight decay"):
        ck.init_optimizer_state(torch.optim.SGD([torch.nn.Parameter(torch.ones(1))],
                                                lr=0.1, weight_decay=0.1))


def test_optimizer_leaf_restores_state_and_param_groups_in_place(cpu_world, tmp_path):
    path = str(tmp_path / "c")
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(5))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1, momentum=0.9), [("w", w)])
    w.sum().backward()
    opt.step()
    opt.optimizer.param_groups[0].update(lr=0.35, momentum=0.8)
    want = opt.optimizer.state[w]["momentum_buffer"].clone()
    ck.save(path, {"opt": opt}, step=1)
    plain = torch.load(os.path.join(path, "step_1", ck.STATE_FILE), weights_only=True)
    assert plain["opt"]["param_groups"][0]["lr"] == 0.35

    w2 = torch.nn.Parameter(torch.zeros(5))
    opt2 = hvd.DistributedOptimizer(torch.optim.SGD([w2], lr=0.1, momentum=0.9),
                                    [("w", w2)])
    with pytest.raises(ValueError, match="init_optimizer_state"):
        ck.restore(path, template={"opt": opt2}, step=1)
    ck.init_optimizer_state(opt2)
    buf = opt2.optimizer.state[w2]["momentum_buffer"]
    ptr = buf.data_ptr()
    got = ck.restore(path, template={"opt": opt2}, step=1)
    group = opt2.optimizer.param_groups[0]
    assert got["opt"] is opt2 and group["params"] == [w2]
    assert group["lr"] == 0.35 and group["momentum"] == 0.8
    assert opt2.optimizer.state[w2]["momentum_buffer"] is buf and buf.data_ptr() == ptr
    assert torch.equal(buf, want)


def test_resume_mid_warmup_with_an_lr_callback_is_bit_equal(tmp_path):
    """SGD with momentum under ``LearningRateWarmupCallback`` (4 epochs up
    to 4x), 2 steps an epoch, stopped after epoch 3 of 6 and resumed into a
    model and optimizer drawn from another seed. The momentum correction
    scales the buffer by lr_e / lr_(e-1) read from the live group, so the
    restored group must hold epoch 2's lr, not the constructor's. The
    callback is built before the restore, as a script builds it, so its
    base lr is the constructor's."""
    path = str(tmp_path / "c")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))

    def build(seed):
        torch.manual_seed(seed)
        model = torch.nn.Linear(6, 3)
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        return model, opt, LearningRateWarmupCallback(opt, warmup_epochs=4, size=4)

    def epochs(model, opt, cb, first, last):
        lrs = []
        for e in range(first, last):
            cb.on_epoch_begin(e)
            lrs.append(opt.param_groups[0]["lr"])
            for _ in range(2):
                opt.zero_grad()
                torch.nn.functional.mse_loss(model(x), y).backward()
                opt.step()
        return lrs

    def tensors(model, opt):
        return [p.detach().clone() for p in model.parameters()] + \
            [opt.state[p]["momentum_buffer"].clone() for p in model.parameters()]

    model, opt, cb = build(0)
    straight = epochs(model, opt, cb, 0, 6)
    want = tensors(model, opt)

    model, opt, cb = build(0)
    first = epochs(model, opt, cb, 0, 3)
    ck.save(path, {"model": model.state_dict(), "opt": opt, "epoch": 3}, step=3)
    model, opt, cb = build(1)
    ck.init_optimizer_state(opt)
    got = ck.restore(path, template={"model": model.state_dict(), "opt": opt,
                                     "epoch": 0}, step=3)
    resumed = first + epochs(model, opt, cb, got["epoch"], 6)
    assert resumed == straight
    assert all(torch.equal(a, b) for a, b in zip(tensors(model, opt), want))


# -- resume of the flash TransformerLM ----------------------------------------

SMALL = TrainConfig(vocab=64, dim=64, heads=4, layers=2, seq=128)


def _snapshot(s):
    return {"params": {n: p.detach().clone() for n, p in s.model.named_parameters()},
            "moments": [{k: v.clone() for k, v in st.items()}
                        for st in s.opt.optimizer.state_dict()["state"].values()]}


def _tree(s, step):
    return {"model": s.model.state_dict(), "opt": s.opt, "step": step}


def test_resumed_training_is_bit_equal(monkeypatch, tmp_path):
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(1 << 16))
    tokens = make_batch(SMALL, 0, "cpu")
    s = setup(SMALL, "cpu")
    straight = [s.step(tokens).item() for _ in range(6)]
    want = _snapshot(s)
    hvd.shutdown()

    s = setup(SMALL, "cpu")
    first = [s.step(tokens).item() for _ in range(3)]
    ck.save(str(tmp_path / "c"), _tree(s, 3), step=3)
    hvd.shutdown()
    s = setup(dataclasses.replace(SMALL, seed=1), "cpu")
    try:
        assert not torch.equal(s.model.embed.weight, want["params"]["embed.weight"])
        ck.init_optimizer_state(s.opt)
        got = ck.restore(str(tmp_path / "c"), template=_tree(s, 0),
                         step=ck.latest_step(str(tmp_path / "c")))
        assert got["step"] == 3
        hvd.broadcast_parameters(s.model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(s.opt, root_rank=0)
        resumed = first + [s.step(tokens).item() for _ in range(3)]
        have = _snapshot(s)
    finally:
        hvd.shutdown()
    assert resumed == straight
    for n, p in want["params"].items():
        assert torch.equal(have["params"][n], p), n
    for a, b in zip(have["moments"], want["moments"]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# -- a JAX-package checkpoint carried over --------------------------------------

JAX_KW = dict(vocab=64, dim=64, heads=4, layers=2)


def test_jax_checkpoint_carries_over_to_the_port(tmp_path):
    from horovod_tpu.models import TransformerLM as JaxLM

    tokens = np.random.default_rng(11).integers(0, 64, (2, 128)).astype(np.int32)
    model = JaxLM(**JAX_KW, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.asarray(tokens))["params"]
    ref_ckpt.save(str(tmp_path / "jax"), {"params": params, "epoch": np.int64(2)},
                  step=2)
    restored = ref_ckpt.restore(str(tmp_path / "jax"), step=2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(model.apply({"params": restored["params"]},
                                      jnp.asarray(tokens)))
    port = TransformerLM(**JAX_KW, attention="flash", dtype=torch.float32)
    port.load_state_dict(convert.transformer_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, restored["params"]),
        port.state_dict().keys()))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).numpy()
    assert int(restored["epoch"]) == 2
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -- export for inference ---------------------------------------------------------

SERVE = """
import hashlib, json, os, sys
sys.path.insert(0, os.environ["HVD_REPO"])
import torch
import torch.distributed as dist
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.transformer import TransformerLM
model = TransformerLM(vocab=64, dim=64, heads=4, layers=2, attention="flash",
                      dtype=torch.float32)
state = checkpoint.load_for_inference(os.environ["CK_PATH"],
                                      template={"model": model.state_dict()})
tokens = torch.load(os.environ["CK_TOKENS"], weights_only=True)
with torch.no_grad():
    logits = model.eval()(tokens)
print(json.dumps({"initialized": basics.is_initialized() or dist.is_initialized(),
                  "sha": hashlib.sha256(logits.numpy().tobytes()).hexdigest()}))
"""


def test_export_loads_in_a_process_without_init(cpu_world, tmp_path):
    s_model = TransformerLM(vocab=64, dim=64, heads=4, layers=2, attention="flash",
                            dtype=torch.float32)
    opt = torch.optim.Adam(s_model.parameters(), lr=1e-3)
    tokens = make_batch(SMALL, 3, "cpu")
    serving = ck.export_for_inference(
        str(tmp_path / "serve"),
        {"model": s_model.state_dict(), "opt": opt.state_dict(), "step": 9},
        drop=("opt", "step"))
    assert list(serving) == ["model"]
    torch.save(tokens, tmp_path / "tokens.pt")
    with torch.no_grad():
        want = hashlib.sha256(s_model.eval()(tokens).numpy().tobytes()).hexdigest()
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env.update(HVD_REPO=REPO, CK_PATH=str(tmp_path / "serve"),
               CK_TOKENS=str(tmp_path / "tokens.pt"))
    proc = subprocess.run([sys.executable, "-c", SERVE], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"initialized": False, "sha": want}


# -- a world of two ---------------------------------------------------------------

LEAF_SHAPES = [(5, 3), (7,), (4, 4), (3, 3, 3)]
THRESHOLD = 160      # bytes: several buckets, odd sizes padded to the shard


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_port_ckpt_two")
    rng = np.random.default_rng(21)
    data = {}
    for i, shape in enumerate(LEAF_SHAPES):
        data[f"leaf{i}"] = rng.standard_normal(shape).astype(np.float32)
        data[f"mu{i}"] = rng.standard_normal(shape).astype(np.float32)
    np.savez(tmp / "in.npz", **data)
    port = free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
        env.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_COORD_ADDR=f"127.0.0.1:{port}", CKPT_DIR=str(tmp),
                   CKPT_IN=str(tmp / "in.npz"), CKPT_OUT=str(tmp / "out"),
                   CKPT_THRESHOLD=str(THRESHOLD), OMP_NUM_THREADS="1")
        env.pop("HOROVOD_CKPT_VERIFY_TIMEOUT", None)
        procs.append(subprocess.Popen([sys.executable, WORKER], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors
    out = []
    for rank in range(2):
        with open(tmp / f"out.{rank}.json") as f:
            out.append(json.load(f))
    return {"out": out, "tmp": tmp, "data": data}


DIVERGED = ("checkpoint restore diverged across ranks: ranks [1] read different "
            "state than rank 0 (non-shared or stale filesystem?); restore on rank "
            "0 only and broadcast, or fix the filesystem")
TIMED_OUT = ("checkpoint digest verification did not complete within 5s — "
             "restore(verify=True) is collective and every rank must call it; if "
             "you restore on rank 0 only and broadcast, pass verify=False")


def test_digest_agrees_and_divergence_raises_on_every_rank(two):
    assert [r["digest"]["diverged"] for r in two["out"]] == [DIVERGED, DIVERGED]


def test_digest_wait_is_bounded(two):
    out = two["out"][0]
    assert out["timeout"] == TIMED_OUT
    assert 4.5 <= out["timeout_s"] <= 20


def test_save_barrier_waits_for_rank_zeros_commit(two):
    ranks = [r["barrier"] for r in two["out"]]
    assert all(r["in_place"] for r in ranks)
    assert ranks[1]["save_s"] >= 1.9


def test_broadcast_resume_state_keeps_types(two):
    want = {"epoch": ["int", None, 3], "lr": ["float", None, 0.5],
            "np": ["int64", None, 7], "bf16": ["Tensor", "torch.bfloat16", [1.5, 1.5]],
            "i64": ["Tensor", "torch.int64", [0, 1, 2]],
            "nested": ["list", None, [0, ["a", 0]]]}
    assert [r["resume"] for r in two["out"]] == [want, want]


def test_sharded_checkpoint_holds_the_reference_consolidation(two):
    from horovod_tpu.parallel import sharded as ref_sh

    data = two["data"]
    n = len(LEAF_SHAPES)
    leaves = [jnp.asarray(data[f"leaf{i}"]) for i in range(n)]
    mu = [jnp.asarray(data[f"mu{i}"]) for i in range(n)]
    plan = ref_sh.build_shard_plan(leaves, 2, THRESHOLD, 1)
    assert list(plan.padded_sizes) == two["out"][0]["sharded"]["padded"]
    assert plan.padded_sizes != plan.raw_sizes          # the pad is exercised
    want = ref_sh.unshard_tree({"params": ref_sh.shard_params(leaves, plan),
                                "mu": ref_sh.shard_params(mu, plan)}, plan)
    saved = torch.load(two["tmp"] / "sharded" / "step_2" / ck.STATE_FILE,
                       weights_only=True)
    assert saved["step"].item() == 3.0
    for key in ("params", "mu"):
        assert len(saved[key]) == n
        for got, ref in zip(saved[key], want[key]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("into", ["2x1", "flat"])
def test_sharded_checkpoint_restores_into_other_layouts(two, into):
    data = two["data"]
    for out in two["out"]:
        got = out["sharded"][into]
        for key, prefix in (("params", "leaf"), ("mu", "mu")):
            for i, leaf in enumerate(got[key]):
                np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                              data[f"{prefix}{i}"])
    assert [o["sharded"]["2x1_step"] for o in two["out"]] == [3.0, 3.0]


def test_sharded_checkpoint_restores_its_own_layout_in_place(two):
    for out in two["out"]:
        assert out["sharded"]["1x2_rows_equal"]
        assert out["sharded"]["1x2_same_tensors"]
