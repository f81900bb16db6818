"""kubeflow-tpu-torch CLI — the port's deployment workflow surface.

The port's copy of kubeflow_tpu/tools/cli.py, over the port's prototype
registry (``kubeflow_tpu_torch.manifests``: GPU gang shapes,
``nvidia.com/gpu``, ``python -m kubeflow_tpu_torch...`` commands) and the
port's checkpoints (``runtime/checkpoint.py``).  Heir of the reference's
ks workflow (README.md:93-134, user_guide.md:366-410):

  ks generate <proto> <name> --param=v -> kubeflow-tpu-torch generate
                                          <proto> <name> --param v
  ks param set <comp> <k> <v>            ->  ... param set <comp> <k> <v>
  ks show default                        ->  ... show
  ks apply default                       ->  ... apply [--dry-run]
  ks prototype describe <proto>          ->  ... prototype describe <proto>

    python -m kubeflow_tpu_torch.tools.cli init
    python -m kubeflow_tpu_torch.tools.cli generate tpu-job train \
        --param slice_type=h100-8
    python -m kubeflow_tpu_torch.tools.cli show

App state is a plain JSON file (app.yaml equivalent) in the working
directory, so the whole flow is inspectable and diffable.  The reference's
arg-escaping wart (`--`-prefixed values broke ks, user_guide.md:395-397) is
avoided by argparse's `--param key=value` form.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Any, Dict, List

import kubeflow_tpu_torch.manifests  # noqa: F401 - registers prototypes
from kubeflow_tpu_torch.config import ParamError, default_registry
from kubeflow_tpu_torch.config.registry import App
from kubeflow_tpu_torch.manifests.base import to_yaml

APP_FILE = "tpuflow.json"


def _load_app(path: str) -> App:
    app = App()
    if os.path.exists(path):
        with open(path) as f:
            state = json.load(f)
        app.namespace = state.get("namespace", "kubeflow")
        for comp in state.get("components", []):
            app.add(comp["prototype"], comp["name"], **comp["params"])
    return app


def _save_app(app: App, path: str) -> None:
    with open(path, "w") as f:
        json.dump({"namespace": app.namespace, "components": app.components},
                  f, indent=2)
        f.write("\n")


def _parse_params(pairs: List[str]) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ParamError(f"--param must be key=value, got {pair!r}")
        key, value = pair.split("=", 1)
        params[key] = value
    return params


def cmd_init(args: argparse.Namespace) -> int:
    app = App(namespace=args.namespace)
    _save_app(app, args.app_file)
    print(f"initialized {args.app_file} (namespace={args.namespace})")
    return 0


def cmd_generate(args: argparse.Namespace) -> int:
    app = _load_app(args.app_file)
    app.add(args.prototype, args.name, **_parse_params(args.param))
    _save_app(app, args.app_file)
    print(f"generated component {args.name} from prototype {args.prototype}")
    return 0


def cmd_param_set(args: argparse.Namespace) -> int:
    app = _load_app(args.app_file)
    app.set_param(args.component, args.key, args.value)
    _save_app(app, args.app_file)
    print(f"set {args.component}.{args.key} = {args.value}")
    return 0


def cmd_show(args: argparse.Namespace) -> int:
    app = _load_app(args.app_file)
    sys.stdout.write(to_yaml(app.render()))
    return 0


def _component_subset(app: App, name: str) -> App:
    have = [c["name"] for c in app.components]
    if name not in have:
        raise ValueError(f"no component named {name!r}; have {have}")
    sub_app = App(namespace=app.namespace)
    for c in app.components:
        if c["name"] == name:
            sub_app.add(c["prototype"], c["name"], **c["params"])
    return sub_app


def _render_and_pipe(args: argparse.Namespace, kubectl: List[str]) -> int:
    """Shared apply/delete flow: load, render (optionally one
    component), print on --dry-run, else pipe to kubectl."""
    app = _load_app(args.app_file)
    if getattr(args, "component", None):
        app = _component_subset(app, args.component)
    manifest = to_yaml(app.render())
    if args.dry_run:
        sys.stdout.write(manifest)
        return 0
    proc = subprocess.run(kubectl, input=manifest.encode())
    return proc.returncode


def cmd_apply(args: argparse.Namespace) -> int:
    """Render and apply via kubectl — same final hop as the reference's
    bootstrapper (`ks show default | kubectl apply -f -`,
    bootstrap/cmd/bootstrap/app/server.go:514-533)."""
    return _render_and_pipe(args, ["kubectl", "apply", "-f", "-"])


def cmd_delete(args: argparse.Namespace) -> int:
    """Render and delete via kubectl — the ``ks delete`` heir
    (user_guide.md:409,439,489: the reference lifecycle ended with
    ``ks delete default``).  Tears down the deployed resources; the app
    state file is untouched (delete is a cluster operation, not an app
    edit — re-``apply`` restores the same deployment).  With a
    component name, only that component's manifests are deleted.
    --ignore-not-found: deleting an app that is partially deployed (or
    torn down twice) is a no-op, not an error — kubectl's own
    idempotent-teardown convention."""
    return _render_and_pipe(
        args, ["kubectl", "delete", "--ignore-not-found", "-f", "-"])


def cmd_prototype(args: argparse.Namespace) -> int:
    if args.action == "list":
        for name in default_registry.names():
            proto = default_registry.get(name)
            print(f"{name:24s} {proto.doc.splitlines()[0] if proto.doc else ''}")
    else:
        print(default_registry.get(args.prototype).describe())
    return 0


def cmd_bootstrap(args: argparse.Namespace) -> int:
    from kubeflow_tpu_torch.tools import bootstrap as boot

    argv = []
    if args.config:
        argv += ["--config", args.config]
    if args.apply:
        argv += ["--apply"]
    if args.namespace:
        argv += ["--namespace", args.namespace]
    return boot.main(argv)


def cmd_fleet_status(args: argparse.Namespace) -> int:
    """Print the fleet router's live endpoint table — the operator's
    one-glance view of replica health (GET /fleet/endpoints on the
    router, fleet/router.py)."""
    import urllib.request

    url = args.router.rstrip("/") + "/fleet/endpoints"
    with urllib.request.urlopen(url, timeout=args.timeout) as resp:
        payload = json.loads(resp.read())
    # Newer routers wrap the endpoint table with the
    # router-wide replay/retry budget; older ones answer a bare list.
    rows = payload.get("endpoints", []) \
        if isinstance(payload, dict) else payload
    if not rows:
        print("no endpoints discovered")
        return 0
    fmt = ("{:<20} {:<10} {:<8} {:<10} {:>9} {:>12} {:>7} {:>7} {:>9}"
           " {:<16}")
    print(fmt.format("ENDPOINT", "STATE", "TIER", "BREAKER",
                     "INFLIGHT", "QUEUE_DEPTH", "CACHE%", "SPILL%",
                     "FAILURES", "ADAPTERS"))
    for row in rows:
        # Prefix-cache effectiveness per replica (engine models only;
        # replicas that predate the metric report "-").  TIER is the
        # disaggregation role the replica advertises on /readyz
        # (prefill/decode/unified — §5.9); pre-tier routers report "-".
        # SPILL% is host spill-tier occupancy (§5.10) — "-" on
        # replicas without a spill tier or pre-spill routers.
        # ADAPTERS lists the adapter variants the replica advertises
        # resident on /readyz (§5.11) — "-" when it serves none.
        ratio = row.get("cached_token_ratio")
        spill = row.get("kv_spill_ratio")
        adapters = sorted({a for names in
                           (row.get("adapters") or {}).values()
                           for a in names})
        print(fmt.format(row["name"], row["state"],
                         row.get("tier", "-"),
                         row.get("breaker_state", "-"),
                         int(row["inflight"]),
                         int(row["queue_depth"]),
                         f"{ratio * 100:.0f}%" if ratio is not None
                         else "-",
                         f"{spill * 100:.0f}%" if spill else "-",
                         row["breaker_failures"],
                         ",".join(adapters) if adapters else "-"))
    if isinstance(payload, dict):
        budget = payload.get("retry_budget") or {}
        tokens, cap = budget.get("tokens"), budget.get("cap")
        if tokens is not None:
            print(f"retry budget: {tokens:.1f}/{cap:.0f} tokens; "
                  f"replay cap {payload.get('max_replays', '-')} "
                  f"per request")
        # Shared train/serve chip pool (scheduler/colocate.py): the
        # arbiter's snapshot rides the serving claim's status back to
        # the router.  Only colocation-mode routers report it.
        pool = payload.get("pool")
        if pool:
            print(f"pool: {pool.get('used_chips', 0)}/"
                  f"{pool.get('capacity_chips', 0)} chips used "
                  f"({pool.get('serving_chips', 0)} serving, "
                  f"{pool.get('training_chips', 0)} training, "
                  f"{pool.get('free_chips', 0)} free)")
    return 0


def cmd_queue_status(args: argparse.Namespace) -> int:
    """Print the training scheduler's live queue — the operator's
    one-glance view of multi-tenant admission (GET /queue on the
    operator's metrics port, scheduler/queue.py), the way
    ``fleet status`` renders serving replicas."""
    import urllib.request

    url = args.operator.rstrip("/") + "/queue"
    with urllib.request.urlopen(url, timeout=args.timeout) as resp:
        payload = json.loads(resp.read())
    jobs = payload.get("jobs", [])
    if not jobs:
        print("queue empty: no live TPUJobs")
    else:
        fmt = ("{:<28} {:<14} {:<12} {:<8} {:>10} {:>6} {:>7} {:<20}"
               " {:>8}")
        print(fmt.format("JOB", "KIND", "TENANT", "PRIORITY", "SLICES",
                         "CHIPS", "MEMBERS", "STATE", "WAIT_S"))
        for row in jobs:
            wait = row.get("wait_s")
            state = row["state"]
            if row.get("resumable") and state not in ("Admitted",
                                                      "Preempting"):
                state += "*"  # resumable: restarts from checkpoint
            # A fused member's CHIPS is its billed SHARE of the gang
            # slice (scheduler/fuse.py) — possibly fractional.  KIND
            # separates training gangs from the fleet autoscaler's
            # serving claims on the same pool (scheduler/colocate.py);
            # pre-colocation operators report no kind -> "train".
            print(fmt.format(row["job"], row.get("kind", "train"),
                             row["tenant"], row["priority"],
                             row["slices"], f"{row['chips']:g}",
                             row.get("members") or "-", state,
                             f"{wait:.1f}" if wait is not None else "-"))
    for q in payload.get("quotas", []):
        print(f"quota {q['tenant']}/{q['slice_type']}: "
              f"{q['used_chips']}/{q['quota_chips']} chips")
    waits = payload.get("queue_wait", {})
    counters = payload.get("counters", {})
    p50, p99 = waits.get("p50"), waits.get("p99")
    print(f"queue wait p50/p99: "
          f"{'-' if p50 is None else '%.1fs' % p50}/"
          f"{'-' if p99 is None else '%.1fs' % p99}  "
          f"admitted={counters.get('admitted', 0)} "
          f"backfilled={counters.get('backfilled', 0)} "
          f"preempted={counters.get('preempted', 0)} "
          f"resumed={counters.get('resumed', 0)}")
    return 0


def _fetch_traces(target: str, timeout: float) -> Dict[str, Any]:
    import urllib.request

    url = target.rstrip("/") + "/debug/traces"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def cmd_trace_list(args: argparse.Namespace) -> int:
    """Print the retained request traces of one /debug/traces server
    (model server REST port, fleet router port, or operator metrics
    port) — the tail-sampled store from runtime/tracing.py."""
    payload = _fetch_traces(args.target, args.timeout)
    if not payload.get("enabled", False):
        print("tracing disabled on this server")
        return 0
    traces = payload.get("traces", [])
    if not traces:
        print("no retained traces (tail sampling kept nothing yet)")
        return 0
    fmt = "{:<34} {:<22} {:<18} {:>11} {:>6} {:<8}"
    print(fmt.format("TRACE_ID", "ROOT", "STATUS", "DURATION_MS",
                     "SPANS", "KEPT_BY"))
    for t in traces:
        print(fmt.format(t["trace_id"], t.get("root", ""),
                         t.get("status", ""),
                         t.get("duration_ms", 0.0),
                         len(t.get("spans", [])),
                         t.get("retained", "")))
    return 0


def _render_span_tree(spans: List[Dict[str, Any]], out) -> None:
    """Indent spans under their parents (orphans — e.g. the replica
    half of a cross-process trace whose router parent lives in another
    store — render as extra roots), durations and attrs inline."""
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[Any, List[dict]] = {}
    for s in spans:
        parent = s.get("parent_id")
        key = parent if parent in by_id else None
        children.setdefault(key, []).append(s)

    def walk(span: Dict[str, Any], depth: int) -> None:
        attrs = " ".join(f"{k}={v}" for k, v in
                         sorted((span.get("attrs") or {}).items()))
        print(f"{'  ' * depth}{'└─ ' if depth else ''}"
              f"{span['name']}  {span.get('duration_ms', 0.0)}ms  "
              f"{span.get('status', '')}"
              f"{('  ' + attrs) if attrs else ''}", file=out)
        kids = sorted(children.get(span["span_id"], []),
                      key=lambda s: s.get("start_s", 0.0))
        for kid in kids:
            walk(kid, depth + 1)

    roots = sorted(children.get(None, []),
                   key=lambda s: s.get("start_s", 0.0))
    for root in roots:
        walk(root, 0)


def cmd_trace_show(args: argparse.Namespace) -> int:
    """Render one trace's span tree (trace_id may be a unique
    prefix)."""
    payload = _fetch_traces(args.target, args.timeout)
    if not payload.get("enabled", False):
        print("tracing disabled on this server")
        return 1
    matches = [t for t in payload.get("traces", [])
               if t["trace_id"].startswith(args.trace_id)]
    if not matches:
        print(f"error: no retained trace matches {args.trace_id!r}",
              file=sys.stderr)
        return 1
    if len(matches) > 1:
        print(f"error: {args.trace_id!r} is ambiguous "
              f"({len(matches)} matches)", file=sys.stderr)
        return 1
    trace = matches[0]
    print(f"trace {trace['trace_id']}  status={trace.get('status')}  "
          f"duration={trace.get('duration_ms')}ms  "
          f"kept_by={trace.get('retained')}")
    _render_span_tree(trace.get("spans", []), sys.stdout)
    return 0


def _checkpoint_rows(directory: str):
    """(step, status, reason, files, size) per step dir, oldest
    first — shared by ``checkpoints list`` and ``checkpoints verify``.

    Status mirrors restore_or_init's walk-back exactly: ``verified``
    (manifest digests clean), ``legacy`` (no manifest AND older than
    every manifested step — pre-manifest checkpoints stay restore
    candidates), or ``corrupt`` (failed verification, or a manifest-
    less step at/after the manifest frontier = a save that died
    mid-commit)."""
    from kubeflow_tpu_torch.runtime import checkpoint as ckpt

    steps = ckpt.list_checkpoint_steps(directory)
    manifested = [s for s in steps
                  if ckpt.manifest_path(directory, s).exists()]
    legacy_below = min(manifested) if manifested else None
    rows = []
    for step in steps:
        ok, reason = ckpt.verify_step(directory, step)
        status = "verified" if ok else "corrupt"
        if not ok and step not in manifested and (
                legacy_below is None or step < legacy_below):
            status, reason = "legacy", "pre-manifest restore candidate"
        mpath = ckpt.manifest_path(directory, step)
        files = size = None
        if mpath.exists():
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                listed = manifest.get("files", {})
                files = len(listed)
                size = sum(v.get("size", 0) for v in listed.values())
            except (OSError, ValueError):
                pass
        rows.append((step, status, reason, files, size))
    return rows


def _resume_step(rows):
    """The step restore_or_init would land on: newest verified, else
    newest legacy candidate (legacy steps are by construction older
    than every verified one)."""
    candidates = [s for s, status, *_ in rows
                  if status in ("verified", "legacy")]
    return max(candidates, default=None)


def _print_checkpoint_table(rows, indent: str = "") -> None:
    fmt = indent + "{:>10} {:<10} {:>7} {:>9}  {}"
    print(fmt.format("STEP", "STATUS", "FILES", "SIZE_MB", "DETAIL"))
    resume = _resume_step(rows)
    for step, status, reason, files, size in rows:
        detail = "" if status == "verified" else reason
        if step == resume:
            detail = ("<- restore_or_init resumes here"
                      + (" (legacy, no manifest)"
                         if status == "legacy" else ""))
        print(fmt.format(step, status,
                         files if files is not None else "-",
                         f"{size / 1e6:.1f}" if size is not None
                         else "-", detail))


def _member_checkpoint_dirs(directory: str):
    """(name, rows) per immediate subdirectory holding checkpoint
    steps — the fused-gang layout (runtime/hfta.py saves member i
    under ``<dir>/<member-name>/``)."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    members = []
    for name in names:
        sub = os.path.join(directory, name)
        if not os.path.isdir(sub):
            continue
        rows = _checkpoint_rows(sub)
        if rows:
            members.append((name, rows))
    return members


def cmd_checkpoints_list(args: argparse.Namespace) -> int:
    """Table of the checkpoint steps under a directory with their
    verification verdicts — the on-disk analogue of ``queue status``
    (what would restore_or_init pick, and why).  A fused-gang
    directory (no steps at the root, per-member subdirectories from
    runtime/hfta.py) renders one verdict table per member."""
    rows = _checkpoint_rows(args.directory)
    if rows:
        _print_checkpoint_table(rows)
        return 0
    members = _member_checkpoint_dirs(args.directory)
    if not members:
        print(f"no checkpoint steps under {args.directory}")
        return 0
    for i, (name, member_rows) in enumerate(members):
        if i:
            print()
        print(f"member {name}:")
        _print_checkpoint_table(member_rows, indent="  ")
    return 0


def cmd_checkpoints_verify(args: argparse.Namespace) -> int:
    """Re-digest every step against its manifest.  Exit 0: all steps
    verified.  Exit 2: some steps unverified but a restore candidate
    (verified, or legacy pre-manifest) exists — walk-back recovers.
    Exit 1: nothing restorable."""
    rows = _checkpoint_rows(args.directory)
    if not rows:
        print(f"no checkpoint steps under {args.directory}")
        return 1
    for step, status, reason, _, _ in rows:
        verdict = ("OK" if status == "verified"
                   else "LEGACY (no manifest; restore would be "
                        "attempted)" if status == "legacy"
                   else f"FAIL ({reason})")
        print(f"step {step}: {verdict}")
    verified = [s for s, status, *_ in rows if status == "verified"]
    legacy = [s for s, status, *_ in rows if status == "legacy"]
    bad = len(rows) - len(verified)
    if verified:
        print(f"newest verified step: {max(verified)} "
              f"({bad} of {len(rows)} step(s) unverified)")
    elif legacy:
        print(f"no verified steps; {len(legacy)} legacy "
              f"(pre-manifest) step(s) remain restore candidates — "
              f"newest: {max(legacy)}")
    else:
        print(f"no restorable steps ({len(rows)} checked) — "
              f"restore_or_init would start from scratch")
    if len(verified) == len(rows):
        return 0
    return 2 if (verified or legacy) else 1


def cmd_version(args: argparse.Namespace) -> int:
    from kubeflow_tpu_torch.version import version_info

    print(json.dumps(version_info()))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeflow-tpu-torch",
        description="Deploy and manage the PyTorch/GPU ML platform.",
    )
    parser.add_argument("--app-file", default=APP_FILE,
                        help="app state file (default: %(default)s)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="create a new app")
    p.add_argument("--namespace", default="kubeflow")
    p.set_defaults(func=cmd_init)

    p = sub.add_parser("generate", help="instantiate a prototype")
    p.add_argument("prototype")
    p.add_argument("name")
    p.add_argument("--param", action="append", default=[],
                   metavar="KEY=VALUE")
    p.set_defaults(func=cmd_generate)

    p = sub.add_parser("param", help="get/set component params")
    psub = p.add_subparsers(dest="action", required=True)
    pset = psub.add_parser("set")
    pset.add_argument("component")
    pset.add_argument("key")
    pset.add_argument("value")
    pset.set_defaults(func=cmd_param_set)

    p = sub.add_parser("show", help="render manifests to stdout")
    p.set_defaults(func=cmd_show)

    p = sub.add_parser("apply", help="render and kubectl-apply")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=cmd_apply)

    p = sub.add_parser(
        "delete",
        help="render and kubectl-delete (teardown, the ks delete heir)")
    p.add_argument("component", nargs="?", default=None,
                   help="only this component (default: the whole app)")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(func=cmd_delete)

    p = sub.add_parser("prototype", help="inspect prototypes")
    psub = p.add_subparsers(dest="action", required=True)
    plist = psub.add_parser("list")
    plist.set_defaults(func=cmd_prototype, action="list")
    pdesc = psub.add_parser("describe")
    pdesc.add_argument("prototype")
    pdesc.set_defaults(func=cmd_prototype, action="describe")

    p = sub.add_parser(
        "bootstrap",
        help="one-shot platform install from a BootConfig YAML "
             "(heir of the reference's bootstrapper)")
    p.add_argument("--config", default=None)
    p.add_argument("--apply", action="store_true")
    p.add_argument("--namespace", default=None)
    p.set_defaults(func=cmd_bootstrap)

    p = sub.add_parser(
        "fleet",
        help="inspect the serving fleet control plane (fleet/main.py)")
    fsub = p.add_subparsers(dest="action", required=True)
    fstat = fsub.add_parser("status",
                            help="live replica table from the router")
    fstat.add_argument("--router", default="http://127.0.0.1:8080",
                       help="router base URL (default: %(default)s)")
    fstat.add_argument("--timeout", type=float, default=10.0)
    fstat.set_defaults(func=cmd_fleet_status)

    p = sub.add_parser(
        "queue",
        help="inspect the multi-tenant training scheduler "
             "(scheduler/)")
    qsub = p.add_subparsers(dest="action", required=True)
    qstat = qsub.add_parser(
        "status", help="live queue/quota table from the operator")
    qstat.add_argument("--operator", default="http://127.0.0.1:9090",
                       help="operator metrics base URL "
                            "(default: %(default)s)")
    qstat.add_argument("--timeout", type=float, default=10.0)
    qstat.set_defaults(func=cmd_queue_status)

    p = sub.add_parser(
        "trace",
        help="inspect distributed request traces (/debug/traces on "
             "the model server, fleet router, or operator)")
    trsub = p.add_subparsers(dest="action", required=True)
    tlist = trsub.add_parser(
        "list", help="retained traces, newest first")
    tlist.add_argument("--target", default="http://127.0.0.1:8000",
                       help="any /debug/traces server: model server "
                            "REST port, router port, or operator "
                            "metrics port (default: %(default)s)")
    tlist.add_argument("--timeout", type=float, default=10.0)
    tlist.set_defaults(func=cmd_trace_list)
    tshow = trsub.add_parser(
        "show", help="span tree of one trace with durations")
    tshow.add_argument("trace_id",
                       help="trace id (a unique prefix works)")
    tshow.add_argument("--target", default="http://127.0.0.1:8000",
                       help="any /debug/traces server "
                            "(default: %(default)s)")
    tshow.add_argument("--timeout", type=float, default=10.0)
    tshow.set_defaults(func=cmd_trace_show)

    p = sub.add_parser(
        "checkpoints",
        help="inspect a training checkpoint directory's integrity "
             "manifests (runtime/checkpoint.py)")
    csub = p.add_subparsers(dest="action", required=True)
    clist = csub.add_parser(
        "list", help="steps + verification verdicts, oldest first")
    clist.add_argument("directory",
                       help="checkpoint root (the CheckpointManager "
                            "directory)")
    clist.set_defaults(func=cmd_checkpoints_list)
    cverify = csub.add_parser(
        "verify", help="re-digest every step against its manifest")
    cverify.add_argument("directory")
    cverify.set_defaults(func=cmd_checkpoints_verify)

    p = sub.add_parser("version", help="print version info")
    p.set_defaults(func=cmd_version)

    return parser


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except ParamError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
