"""CLI: python -m horovod_tpu_torch.runner [-np N | -H host1:4,host2:4]
[--env K=V ...] -- command ...

The horovodrun analog for the port: the counterpart of
``horovod_tpu.runner``'s ``hvdrun``. With -H, workers are spawned through
each host's resident hvd-agent daemon
(``python -m horovod_tpu_torch.runner.agent``). The JAX launcher's
``--jax-distributed`` has no counterpart: each launched job forms one
``torch.distributed`` world."""

from __future__ import annotations

import argparse
import os
import sys

# The GPUs are probed in a child process, with this bound: a wedged driver
# blocks the CUDA runtime's initialization, and a diagnostics command must
# report that, not hang.
PROBE_TIMEOUT_S = 60


def _kernel_builds() -> list[str]:
    """One line per CUDA source: its library if built, else where and how
    it would build at first use. Builds nothing."""
    from ..ops import _build

    lines = []
    for source in sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu")):
        lib = _build._library_path(source)
        if os.path.exists(lib):
            lines.append(f"  CUDA kernels, {source}: built ({lib})")
            continue
        try:
            how = f"nvcc at {_build.nvcc()}"
        except RuntimeError as e:
            how = str(e)
        lines.append(f"  CUDA kernels, {source}: not built (builds at first "
                     f"use into {_build.BUILD_DIR}; {how})")
    return lines


def _probe_gpus() -> str:
    import subprocess

    # One |-delimited line after a sentinel, so banner noise on stdout
    # cannot confuse the parse.
    probe = ("import torch; n = torch.cuda.device_count(); "
             "print('HVDPROBE|%d|%s' % (n, torch.cuda.get_device_name(0) "
             "if n else ''))")
    try:
        out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                             text=True, timeout=PROBE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return (f"probe HUNG (>{PROBE_TIMEOUT_S}s): the CUDA driver is "
                "unreachable; CPU-only work is unaffected")
    line = next((ln for ln in out.stdout.splitlines()
                 if ln.startswith("HVDPROBE|")), None)
    if out.returncode != 0 or line is None:
        err = (out.stderr.strip().splitlines() or ["no error output"])[-1]
        return f"probe failed ({err[:120]})"
    _, n, name = line.split("|", 2)
    return f"{n} x {name}" if int(n) else "none"


def check_build() -> int:
    """Report what this installation supports (reference
    `horovodrun --check-build`): the native eager engine (built here if it
    is not yet), torch and its backends, the port's CUDA kernels' build,
    and the visible GPUs."""
    import torch
    import torch.distributed as dist

    print("horovod_tpu_torch build check")
    native_err = ""
    try:
        from ..cc import lib_path

        native = f"yes ({lib_path()})"  # builds the core if needed
    except Exception as e:  # noqa: BLE001 - report, don't crash
        native = "NO"
        native_err = f"    ({type(e).__name__}: {e})"
    print(f"  native eager engine (C++): {native}")
    if native_err:
        print(native_err)
    print(f"  torch: {torch.__version__}")
    print(f"  CUDA: {'yes (' + torch.version.cuda + ')' if torch.version.cuda else 'NO'}"
          f" (available: {'yes' if torch.cuda.is_available() else 'NO'})")
    nccl = dist.is_available() and dist.is_nccl_available()
    print(f"  NCCL (GPU collectives): {'yes' if nccl else 'NO'}")
    gloo = dist.is_available() and dist.is_gloo_available()
    print(f"  gloo (CPU collectives): {'yes' if gloo else 'NO'}")
    for line in _kernel_builds():
        print(line)
    print(f"  GPUs: {_probe_gpus()}")
    print("  collectives: allreduce allgather broadcast alltoall "
          "reducescatter (+ sparse, hierarchical)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner",
        description="Launch a command on N horovod_tpu_torch worker "
                    "processes, locally (-np) or across hosts via hvd-agents "
                    "(-H).",
    )
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="number of worker processes (local launch)")
    parser.add_argument("-H", "--hosts", default=None, metavar="host1:4,host2:4",
                        help="remote launch: slots per host, spawned via each "
                             "host's hvd-agent (host[@agent_port][:slots])")
    parser.add_argument("--agent-port", type=int, default=None,
                        help="default hvd-agent port for -H hosts")
    parser.add_argument("--agent-secret-file", default=None,
                        help="file with the shared hvd-agent secret "
                             "(hex or raw; default: HOROVOD_AGENT_SECRET env)")
    parser.add_argument("--env", action="append", default=[],
                        metavar="K=V", help="extra env var for workers")
    parser.add_argument("--check-build", action="store_true",
                        help="print what this installation can do (torch, "
                             "CUDA, NCCL, gloo, the CUDA kernels' build, "
                             "GPUs) and exit")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="command to run (prefix with --)")
    args = parser.parse_args(argv)
    if args.check_build:
        return check_build()
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given; usage: -np 4 -- python train.py")
    if args.num_proc is None and args.hosts is None:
        parser.error("one of -np or -H is required")
    extra_env = {}
    for kv in args.env:
        k, _, v = kv.partition("=")
        extra_env[k] = v

    agent_secret = None
    if args.agent_secret_file:
        from .agent import _load_secret

        agent_secret = _load_secret(args.agent_secret_file)

    from . import run_command

    return run_command(command, num_proc=args.num_proc, env=extra_env,
                       hosts=args.hosts, agent_port=args.agent_port,
                       agent_secret=agent_secret)


if __name__ == "__main__":
    sys.exit(main())
