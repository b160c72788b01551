"""The sanitizer leg over the port's C++ core
(``tools/torch_sanitize_smoke.py``).

- Tier-1 drives it at a reduced depth: the ASan + UBSan build and the ASan
  ring stress binary (one ``make``), the native-engine subset that goes
  through ``hvd_coord_listen`` and the adoption of its socket by
  ``hvd_init`` (the descriptor-count test) and a world of one through every
  op and dtype, against the ASan build, then ``ring_stress.asan``; each
  under its own timeout; 0 unvetted reports.
- The whole leg (the UBSan and TSan builds too, the whole not-slow subset
  of both native-engine files under ASan, ``ring_stress.tsan``) takes
  about eight minutes on an 8-core host, so it is marked slow.
- The report sweep: every sanitizer's report line is caught, and a vetted
  key lets its line through.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_sanitize_smoke.py")


def _tool():
    spec = importlib.util.spec_from_file_location("_torch_sanitize", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leg(args, timeout) -> dict:
    r = subprocess.run([sys.executable, TOOL, *args], capture_output=True,
                       text=True, timeout=timeout, cwd=REPO)
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0 and summary["ok"], \
        r.stdout[-3000:] + r.stderr[-3000:]
    assert summary["reports"] == []
    return summary


def test_reduced_leg_asan_subset_and_stress():
    s = _leg(["--builds", "asan", "--stress", "asan",
              "--build-timeout", "300", "--test-timeout", "300",
              "--stress-timeout", "120",
              "-k", "listener_cycles or world_of_one_every_op"], timeout=800)
    assert s["builds"] == {"asan": True, "asan_stress": True}
    assert s["tests_rc"] == 0 and s["tests"].startswith("2 passed")
    assert s["stress"] == {"ring_stress.asan": 0}


@pytest.mark.slow
def test_whole_leg():
    s = _leg([], timeout=1800)
    assert all(s["builds"].values()) and len(s["builds"]) == 5
    assert s["stress"] == {"ring_stress.asan": 0, "ring_stress.tsan": 0}


@pytest.mark.parametrize("line", [
    "==1==ERROR: AddressSanitizer: heap-use-after-free on address 0x1",
    "==1==ERROR: LeakSanitizer: detected memory leaks",
    "src/ring.h:10:5: runtime error: signed integer overflow",
    "WARNING: ThreadSanitizer: data race (pid=1)",
    "==1==AddressSanitizer CHECK failed: x",
])
def test_sweep_catches_each_report_and_lets_a_vetted_key_through(line):
    tool = _tool()
    assert tool.sweep(f"ok\n{line}\nok", set()) == ([line], [])
    frame = line.split()[-1]
    assert tool.sweep(line, {f"sanitizer:any:{frame}"}) == ([], [line])
    assert tool.sweep("all clean\n", {f"sanitizer:any:{frame}"}) == ([], [])


def test_port_allowlist_parses():
    assert all(k.startswith("sanitizer:") for k in _tool().vetted_keys())
