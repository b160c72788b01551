#!/usr/bin/env python
"""The sanitizer leg over the port's C++ core (``horovod_tpu_torch/cc``):
the counterpart of ``tools/sanitize_smoke.py``.

1. Builds the ``asan`` (ASan + UBSan), ``ubsan`` and ``tsan`` variants of
   the core from ``horovod_tpu_torch/cc/Makefile``; a build that fails
   fails the leg.
2. Runs the port's native-engine tests (``tests/test_torch_port_native_
   engine.py`` and ``tests/test_torch_port_native_world.py``, not slow)
   against the ASan build: ``HVD_NATIVE_LIB`` points every process at it
   (test subprocesses inherit the env), libasan and libstdc++ are
   preloaded into python (the core throws through its auth and shutdown
   paths, and ASan's ``__cxa_throw`` interceptor needs libstdc++ resolved),
   ``ASAN_OPTIONS=detect_leaks=0:abort_on_error=1`` (CPython's interned
   objects would read as leaks at exit) and UBSan halts on its first
   report. The subset includes
   ``test_coordinator_listener_cycles_leave_no_descriptor``, which drives
   ``hvd_coord_listen`` and the adoption of its socket by ``hvd_init``,
   the one code path the port's core adds to the JAX one.
3. Builds and runs ``ring_stress`` (dense, bf16 and sparse top-k ring
   reduces across thread-ranks with a chaos reset) as standalone binaries
   under ASan and under TSan: no CPython in the process, so TSan runs
   there where it cannot under a python.
4. Sweeps every output for sanitizer reports. A report passes only if its
   ``sanitizer:<tool>:<frame>`` key is vetted in
   ``tools/analyze/suppressions.toml`` or, for a finding of the port's
   core alone, in ``tools/torch_sanitize_suppressions.toml``, each entry
   with its reason.

    python tools/torch_sanitize_smoke.py                 # the whole leg
    python tools/torch_sanitize_smoke.py --builds asan --stress asan \\
        -k "listener_cycles or world_of_one"              # a reduced depth

The last line of stdout is one JSON object: the builds, the tests' exit
code, the stress binaries run, the report lines found and those vetted.
Exits 0 only when every step passed with no unvetted report.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CC_DIR = os.path.join(REPO, "horovod_tpu_torch", "cc")
TESTS = ["tests/test_torch_port_native_engine.py",
         "tests/test_torch_port_native_world.py"]
BUILDS = ("asan", "ubsan", "tsan")
STRESS = {
    "asan": ("asan_stress", "ring_stress.asan",
             {"ASAN_OPTIONS": "abort_on_error=1",
              "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}),
    "tsan": ("tsan_stress", "ring_stress.tsan",
             {"TSAN_OPTIONS": "halt_on_error=1:second_deadlock_stack=1"}),
}
PORT_SUPPRESSIONS = os.path.join(REPO, "tools", "torch_sanitize_suppressions.toml")

REPORT_RE = re.compile(
    r"ERROR: AddressSanitizer|ERROR: LeakSanitizer|runtime error:|"
    r"AddressSanitizer CHECK failed|(?:ERROR|WARNING): ThreadSanitizer")


def run(cmd, **kw) -> subprocess.CompletedProcess:
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, capture_output=True, text=True, **kw)


def gcc_file(name: str) -> str:
    out = subprocess.run(["g++", f"-print-file-name={name}"],
                         capture_output=True, text=True).stdout.strip()
    return out if os.path.sep in out and os.path.exists(out) else ""


def vetted_keys() -> set:
    """``sanitizer:`` keys of the JAX leg's allowlist and the port's own."""
    sys.path.insert(0, REPO)
    from tools.analyze.common import load_suppressions, parse_suppressions

    sups = list(load_suppressions(REPO))
    if os.path.exists(PORT_SUPPRESSIONS):
        with open(PORT_SUPPRESSIONS, encoding="utf-8") as f:
            sups += parse_suppressions(f.read())
    return {s.key for s in sups if s.key.startswith("sanitizer:")}


def sweep(text: str, vetted: set) -> tuple[list, list]:
    """(unvetted, vetted) report lines of ``text``; a key's frame is the
    part after ``sanitizer:<tool>:``."""
    frames = [k.split(":", 2)[-1] for k in vetted]
    live, ok = [], []
    for ln in text.splitlines():
        if REPORT_RE.search(ln):
            (ok if any(f in ln for f in frames) else live).append(ln)
    return live, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's sanitizer leg")
    p.add_argument("--builds", default=",".join(BUILDS))
    p.add_argument("--stress", default=",".join(STRESS))
    p.add_argument("-k", dest="select", default="",
                   help="pytest -k expression narrowing the ASan subset")
    p.add_argument("--build-timeout", type=float, default=900)
    p.add_argument("--test-timeout", type=float, default=1500)
    p.add_argument("--stress-timeout", type=float, default=180)
    args = p.parse_args(argv)
    builds = [b for b in args.builds.split(",") if b]
    stress = [s for s in args.stress.split(",") if s]
    summary = {"builds": {}, "tests_rc": None, "stress": {},
               "reports": [], "vetted": []}
    vetted = vetted_keys()
    t_start = time.perf_counter()

    def finish(rc: int) -> int:
        summary["seconds"] = round(time.perf_counter() - t_start, 1)
        summary["ok"] = rc == 0
        print(json.dumps(summary), flush=True)
        return rc

    # 1. the builds, at once: each target is one g++ of its own.
    targets = builds + [STRESS[s][0] for s in stress]
    t0 = time.perf_counter()
    r = run(["make", "-C", CC_DIR, f"-j{len(targets)}", *targets],
            timeout=args.build_timeout)
    for target in targets:
        summary["builds"][target] = r.returncode == 0
    summary["build_s"] = round(time.perf_counter() - t0, 1)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        print(f"FAIL: make {' '.join(targets)} did not build", flush=True)
        return finish(1)

    # 2. the native-engine tests against the ASan build.
    if "asan" in builds:
        asan_rt, stdcpp = gcc_file("libasan.so"), gcc_file("libstdc++.so.6")
        if not asan_rt:
            print("FAIL: libasan.so not found beside g++: the leg cannot run "
                  "on this machine", flush=True)
            return finish(1)
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            HVD_NATIVE_LIB=os.path.join(CC_DIR, "libhvd_core.asan.so"),
            LD_PRELOAD=" ".join(x for x in (asan_rt, stdcpp) if x),
            ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
            UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1",
        )
        cmd = [sys.executable, "-m", "pytest", *TESTS, "-q", "-m", "not slow",
               "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly"]
        if args.select:
            cmd += ["-k", args.select]
        t0 = time.perf_counter()
        r = run(cmd, env=env, cwd=REPO, timeout=args.test_timeout)
        summary["tests_rc"] = r.returncode
        summary["tests_s"] = round(time.perf_counter() - t0, 1)
        summary["tests"] = (r.stdout.strip().splitlines() or [""])[-1]
        sys.stdout.write(r.stdout[-2000:])
        live, ok = sweep(r.stdout + r.stderr, vetted)
        summary["reports"] += live
        summary["vetted"] += ok
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            print("FAIL: the native-engine tests failed under ASan + UBSan",
                  flush=True)
            return finish(1)

    # 3. ring_stress, standalone, under each sanitizer asked for.
    for name in stress:
        _, binary, extra = STRESS[name]
        r = run([os.path.join(CC_DIR, binary)], env=dict(os.environ, **extra),
                timeout=args.stress_timeout)
        sys.stdout.write(r.stdout[-1000:])
        live, ok = sweep(r.stdout + r.stderr, vetted)
        summary["stress"][binary] = r.returncode
        summary["reports"] += live
        summary["vetted"] += ok
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            print(f"FAIL: {binary} exited {r.returncode}", flush=True)
            return finish(1)

    # 4. no unvetted report anywhere.
    if summary["reports"]:
        print("FAIL: sanitizer report(s):", flush=True)
        for ln in summary["reports"][:20]:
            print("   ", ln, flush=True)
        print("(vet a false positive with a sanitizer:<tool>:<frame> key and "
              f"its reason in {os.path.relpath(PORT_SUPPRESSIONS, REPO)})",
              flush=True)
        return finish(1)
    print(f"sanitize smoke OK: {', '.join(targets)} built; "
          f"{summary.get('tests', 'no tests')} under ASan + UBSan; "
          f"{', '.join(STRESS[s][1] for s in stress) or 'no stress'} clean; "
          "0 reports", flush=True)
    return finish(0)


if __name__ == "__main__":
    sys.exit(main())
