"""Worker container launcher: the port of kubeflow_tpu/tools/launcher.py.

It reads the ``KFT_*`` contract the operator injects
(``runtime/bootstrap.worker_env``), starts this worker's process group
(``bootstrap.initialize``: NCCL on CUDA, gloo when ``KFT_DIST_BACKEND``
asks; a one-process job needs none), and then either imports a python
entrypoint in-process (so the process group it started is the one the
entrypoint uses) or runs the command after ``--`` and exits with its
exit code.  With nothing to run it exits 2.

    python -m kubeflow_tpu_torch.tools.launcher -- \\
        python -m kubeflow_tpu_torch.tools.train_lm --steps 3
    python -m kubeflow_tpu_torch.tools.launcher \\
        --entrypoint kubeflow_tpu_torch.tools.train_torch:main

A command run after ``--`` is its own process: it starts its own group
from the same variables (the training entry points do), so the
launcher's is skipped there unless ``--entrypoint`` runs in-process
(``--no-distributed`` skips it in any case).  Finishing is just exiting:
the gang's restart policy lives in the operator.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubeflow-tpu-torch-launch")
    ap.add_argument("--entrypoint",
                    help="python entrypoint 'module:function' run "
                         "in-process after the process group starts")
    ap.add_argument("--no-distributed", action="store_true",
                    help="start no process group (single-process debug)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the process group's device: NCCL on cuda, gloo "
                         "on cpu")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command to run (after '--')")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s launcher %(levelname)s %(message)s",
    )
    from kubeflow_tpu_torch.runtime import bootstrap

    env = bootstrap.worker_env()
    logging.info(
        "worker %d/%d (job=%s slice=%s coordinator=%s)",
        env.process_id, env.num_processes, env.job_name or "-",
        env.slice_type or "-", env.coordinator_address or "-",
    )

    if args.entrypoint:
        if not args.no_distributed:
            bootstrap.initialize(env, device=args.device)
        mod_name, _, fn_name = args.entrypoint.partition(":")
        fn = getattr(importlib.import_module(mod_name), fn_name or "main")
        result = fn()
        return int(result or 0)

    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        logging.error("nothing to run: give --entrypoint or a command")
        return 2
    # The child inherits the KFT_* variables and starts its own group;
    # its exit code goes to the operator unchanged.
    proc = subprocess.run(command, env=os.environ)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
