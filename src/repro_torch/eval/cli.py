"""``python -m repro_torch.eval`` — run suites, render tables, list backends.

Commands:
  run       execute suites, write `<out>/<suite>.json` + `<suite>.md`
  render    re-render `<suite>.md` from existing JSON artifacts (no compute)
  backends  list the registered quant backends swept by the task suites

Artifacts go to ``experiments/torch/eval/`` (``--out`` to change it),
never to the JAX package's ``experiments/eval/``. ``--device`` defaults to
``cuda``; ``--device cpu`` runs every suite on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional


def _repo_root() -> Path:
    # src-layout checkout: src/repro_torch/eval/cli.py -> repo root; for an
    # installed package fall back to the working directory
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").exists():
        return root
    return Path.cwd()


REPO_ROOT = _repo_root()
SUITE_HELP = ("'all', one of metrics/hw/denoise/mnist/lm/serve, or a "
              "comma list (e.g. 'metrics,hw')")
DEFAULT_OUT = REPO_ROOT / "experiments" / "torch" / "eval"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval",
        description="Paper-evaluation harness of the PyTorch port")
    sub = ap.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="execute suites and write artifacts")
    run.add_argument("--suite", default="all", help=SUITE_HELP)
    run.add_argument("--smoke", action="store_true",
                     help="minute-scale budgets; same sweep structure as "
                          "the full run")
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--out", type=Path, default=DEFAULT_OUT)
    run.add_argument("--device", default="cuda",
                     help="torch device to run on (default: cuda)")

    rend = sub.add_parser("render",
                          help="re-render markdown from JSON artifacts")
    rend.add_argument("--suite", default="all", help=SUITE_HELP)
    rend.add_argument("--out", type=Path, default=DEFAULT_OUT)

    sub.add_parser("backends", help="list registered quant backends")
    return ap


def _suites(name: str):
    from repro_torch.eval.runners import resolve_suites
    try:
        return resolve_suites(name)
    except KeyError as e:
        print(f"[repro_torch.eval] {e.args[0]}", file=sys.stderr)
        return None


def _cmd_run(args) -> int:
    from repro_torch.eval import artifacts
    from repro_torch.eval.runners import SUITES, render_artifact
    names = _suites(args.suite)
    if names is None:
        return 2
    out: Path = args.out
    out.mkdir(parents=True, exist_ok=True)
    failed = []
    for name in names:
        t0 = time.time()
        # run every requested suite, report the failures explicitly, and
        # exit nonzero if any failed
        try:
            art = SUITES[name].run(smoke=args.smoke, seed=args.seed,
                                   device=args.device)
        except Exception as e:                      # noqa: BLE001
            import traceback
            traceback.print_exc()
            print(f"[repro_torch.eval] FAILED  {name}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            failed.append(name)
            continue
        artifacts.save(out / f"{name}.json", art)
        (out / f"{name}.md").write_text(render_artifact(art))
        print(f"[repro_torch.eval] {name:8s} {time.time() - t0:6.1f}s -> "
              f"{out / (name + '.json')}")
    if failed:
        print(f"[repro_torch.eval] {len(failed)} suite(s) failed: {failed}",
              file=sys.stderr)
        return 1
    return 0


def _cmd_render(args) -> int:
    from repro_torch.eval import artifacts
    from repro_torch.eval.runners import render_artifact
    names = _suites(args.suite)
    if names is None:
        return 2
    for name in names:
        path = args.out / f"{name}.json"
        if not path.exists():
            print(f"[repro_torch.eval] missing artifact {path} (run the "
                  f"suite first)", file=sys.stderr)
            return 1
        (args.out / f"{name}.md").write_text(
            render_artifact(artifacts.load(path)))
        print(f"[repro_torch.eval] rendered {args.out / (name + '.md')}")
    return 0


def _cmd_backends(args) -> int:
    from repro_torch.quant.matmul import backend_notes
    for name, note in backend_notes().items():
        print(f"{name:24s} {note}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    return {"run": _cmd_run, "render": _cmd_render,
            "backends": _cmd_backends}[args.command](args)
