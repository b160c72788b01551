"""The port's serving planes over HTTP with CPU replicas: streaming
generation, and the request-level ``InferenceServer`` against the JAX
package's on the same flax weights.

- Streaming (``HOROVOD_SERVE_LLM_STREAM`` default and the per-request
  flag): the per-token JSONL chunks reassemble to exactly the
  non-streaming body, whose tokens are the port's sequential oracle;
  admission errors answer plain 400 and a deadline that expires mid-stream
  surfaces in-band.
- ``InferenceServer`` with the built-in ``mlp_builder``: a flax MLP
  exported by each package's ``export_for_inference`` and served by each
  package's server; the port's responses within 1e-5 relative of the JAX
  server's (a float32 MLP of three small products summed in numpy's order
  on one side and torch's on the other), and bitwise the port's own
  forward in process at the padding bucket that served them.
- Two replicas, one SIGKILL'd under load: zero failed requests, the
  replacement on the dead replica's device, the drain back to one.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu_torch.serving import model as pm
from horovod_tpu_torch.serving.config import LLMConfig, ServeConfig
from launch_util import REPO

RTOL = 1e-5
TP = pm.lm_params_to_torch(pm.tiny_lm_params(), "cpu")


def _post(port, payload, path="/v1/generate", timeout=120.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _stream(port, payload, timeout=120.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        lines = []
        while True:
            raw = resp.readline()
            if not raw:
                break
            lines.append(json.loads(raw))
        return resp.status, resp.getheader("Transfer-Encoding"), lines
    finally:
        conn.close()


def test_streaming_reassembles_to_the_plain_body():
    from horovod_tpu_torch.serving.llm import LLMServer

    cfg = ServeConfig.from_env(port=0, slo_ms=120000.0,
                               replica_start_timeout_s=180.0)
    llm = LLMConfig.from_env(colocated=1, decode_replicas=1, stream=1)
    server = LLMServer(config=cfg, llm_config=llm, device="cpu").start()
    try:
        assert server.wait_ready(180)
        prompt, n = [3, 17, 5], 24
        want = pm.lm_generate(TP, prompt, n)
        st, plain = _post(server.port, {"prompt": prompt, "max_tokens": n,
                                        "stream": False})
        assert st == 200 and plain["tokens"] == want
        status, te, lines = _stream(server.port, {"prompt": prompt,
                                                  "max_tokens": n})
        assert status == 200 and te == "chunked"    # the env default
        tokens, final = lines[:-1], lines[-1]
        assert set(final) == set(plain) and final["tokens"] == want
        assert [ln["i"] for ln in tokens] == list(range(n))
        assert [ln["token"] for ln in tokens] == want
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.port, {"prompt": [], "stream": True})
        assert ei.value.code == 400
        # The decode worker hands the next request out only once its
        # deadline has passed, as a busy pool would: a request taken within
        # its 1 ms would finish inside the frontend's 50 ms grace and
        # answer 200 with its tokens.
        take = server.take_decode_feed

        def after_the_deadline():
            item = take()
            if item is not None:
                time.sleep(max(0.0, item[0].deadline_t - time.monotonic()))
            return item

        server.take_decode_feed = after_the_deadline
        status, _, lines = _stream(server.port, {
            "prompt": [3, 1], "max_tokens": 16, "deadline_ms": 1})
        server.take_decode_feed = take
        assert status == 200 and "error" in lines[-1]
        cs = server.stats()["metrics"]["counters"]
        assert cs.get("horovod_serve_llm_streams_total", 0) >= 2
    finally:
        server.stop()


def _flax_params(dim: int = 16):
    import jax

    from horovod_tpu.models import MLP

    model = MLP(features=(32, 8))
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((2, dim), np.float32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _drive(server, xs) -> list:
    out = [None] * len(xs)

    def one(i):
        st, body = _post(server.port, {"inputs": xs[i].tolist()},
                         path="/v1/infer")
        assert st == 200
        out[i] = np.asarray(body["outputs"], np.float32)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def test_infer_server_serves_flax_weights_like_jax(tmp_path):
    from horovod_tpu import checkpoint as jck
    from horovod_tpu import serving as jserving
    from horovod_tpu_torch import checkpoint as pck
    from horovod_tpu_torch import serving as pserving
    from horovod_tpu_torch.serving.batcher import bucket_sizes

    model, params = _flax_params()
    jck.export_for_inference(str(tmp_path / "jax"), {"params": params})
    pck.export_for_inference(str(tmp_path / "port"), {"params": params})
    xs = np.random.RandomState(3).uniform(-1, 1, (12, 16)).astype(np.float32)
    kw = dict(port=0, min_replicas=1, max_replicas=1, max_batch=4,
              max_wait_ms=5.0, slo_ms=60000.0, replica_start_timeout_s=180.0)
    port_server = pserving.InferenceServer(
        str(tmp_path / "port"), config=pserving.ServeConfig.from_env(**kw),
        device="cpu").start()
    jax_server = jserving.InferenceServer(
        str(tmp_path / "jax"), config=jserving.ServeConfig.from_env(**kw),
        replica_env={"JAX_PLATFORMS": "cpu"}).start()
    try:
        assert port_server.wait_ready(180) and jax_server.wait_ready(180)
        got, want = _drive(port_server, xs), _drive(jax_server, xs)
        flax = np.asarray(model.apply({"params": params}, xs))
        apply_fn = pm.mlp_builder(pm.load_for_serving(str(tmp_path / "port")),
                                  device="cpu")
        with torch.no_grad():
            refs = {b: np.concatenate([
                apply_fn(np.concatenate([xs[s:s + b], np.zeros(
                    (b - len(xs[s:s + b]), 16), np.float32)])).numpy()[
                        :len(xs[s:s + b])]
                for s in range(0, len(xs), b)]) for b in bucket_sizes(4)}
        for i, (g, w) in enumerate(zip(got, want)):
            assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), i
            assert np.abs(g - flax[i]).max() <= RTOL * np.abs(flax[i]).max()
            assert any(np.array_equal(g, refs[b][i]) for b in refs), i
        stats = port_server.manager.replica_stats()
        assert [s["device"] for s in stats.values()] == ["cpu"]
        assert all(1 <= s["recompiles"] <= 3 for s in stats.values())
    finally:
        port_server.stop()
        jax_server.stop()


def test_infer_server_kill_retry_and_drain(tmp_path):
    from horovod_tpu_torch import checkpoint as pck
    from horovod_tpu_torch.metrics import validate_snapshot
    from horovod_tpu_torch.models.cnn_layers import init_cnn
    from horovod_tpu_torch.models.mlp import MLP
    from horovod_tpu_torch.serving import InferenceServer

    model = MLP(features=(32, 8), in_features=16)
    init_cnn(model, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "serve")
    pck.export_for_inference(ckpt, {"params": model.state_dict()})
    cfg = ServeConfig.from_env(port=0, min_replicas=1, max_replicas=2,
                               max_batch=4, max_wait_ms=5.0, slo_ms=60000.0,
                               cooldown_s=3600.0, replica_start_timeout_s=180.0)
    server = InferenceServer(ckpt, config=cfg, device="cpu").start()
    x = np.linspace(0, 1, 16).astype(np.float32)
    with torch.no_grad():
        expect = model(torch.from_numpy(x[None])).numpy()[0]
    try:
        server.manager.scale_to(2)
        deadline = time.monotonic() + 180
        while server.manager.serving_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert server.manager.serving_count() == 2, server.manager.describe()
        np.testing.assert_allclose(server.infer(x, deadline_ms=60000), expect,
                                   rtol=RTOL)
        failures = []

        def load():
            for _ in range(40):
                try:
                    server.infer(x, deadline_ms=60000)
                except RuntimeError as e:
                    failures.append(str(e))

        threads = [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        victim = next(r for r in server.manager.describe()["replicas"].values()
                      if r["state"] == "serving")
        time.sleep(0.2)
        os.kill(victim["pid"], 9)
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
        assert not failures, failures[:3]
        # The load can finish on the survivor before the supervisor's next
        # tick sees the victim's exit: until then the victim still counts
        # as serving. Wait for its death to be recorded and its respawn.
        deadline = time.monotonic() + 120
        while (server.manager.serving_count() < 2
               or not server.manager.blacklist.blacklisted()) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert server.manager.serving_count() == 2, "no respawn"
        assert server.manager.blacklist.blacklisted()
        server.manager.scale_to(1)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            reps = server.manager.describe()["replicas"]
            if len(reps) == 1 and all(r["state"] == "serving"
                                      for r in reps.values()):
                break
            time.sleep(0.1)
        assert len(server.manager.describe()["replicas"]) == 1
        np.testing.assert_allclose(server.infer(x, deadline_ms=60000), expect,
                                   rtol=RTOL)
        stats = server.stats()
        assert validate_snapshot(stats["metrics"]) == []
        counters = stats["metrics"]["counters"]
        assert counters.get("horovod_serve_replica_deaths_total", 0) >= 1
        assert counters.get("horovod_serve_replica_respawns_total", 0) >= 1
    finally:
        server.stop()


def test_cli_names_the_device_option():
    out = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.serving",
                          "--help"], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert "--device" in out.stdout and "--llm" in out.stdout
