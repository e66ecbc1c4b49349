"""``python -m repro_torch.eval`` — run suites, render tables, list backends.

Commands:
  run       execute suites, write `<out>/<suite>.json` + `<suite>.md`
  render    re-render `<suite>.md` from existing JSON artifacts (no compute)
  docs      inject the rendered tables into docs/reproduce_torch.md between
            `<!-- eval:<suite>:begin/end -->` markers (--check verifies the
            committed document is byte-identical to the regenerated tables)
  backends  list the registered quant backends swept by the task suites

Artifacts go to ``experiments/torch/eval/`` (``--out`` to change it),
never to the JAX package's ``experiments/eval/``; the examples write to
``experiments/torch/scratch/``. ``--device`` defaults to ``cuda``;
``--device cpu`` runs every suite on the CPU.
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
# where the examples and ad-hoc runs write, so that they never dirty the
# committed artifacts that docs --check holds the document to
SCRATCH_OUT = REPO_ROOT / "experiments" / "torch" / "scratch"
DOCS_PATH = REPO_ROOT / "docs" / "reproduce_torch.md"


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

    docs = sub.add_parser("docs",
                          help="sync tables into docs/reproduce_torch.md")
    docs.add_argument("--out", type=Path, default=DEFAULT_OUT,
                      help="artifact directory to render from")
    docs.add_argument("--docs-path", type=Path, default=DOCS_PATH)
    docs.add_argument("--check", action="store_true",
                      help="verify instead of write; exit 1 on drift")

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


def _cmd_docs(args) -> int:
    from repro_torch.eval import artifacts, markdown
    from repro_torch.eval.runners import render_artifact
    text = args.docs_path.read_text()
    drift = []
    for name in markdown.block_names(text):
        path = args.out / f"{name}.json"
        if not path.exists():
            print(f"[repro_torch.eval] missing artifact {path} for docs "
                  f"block {name!r}", file=sys.stderr)
            return 1
        rendered = render_artifact(artifacts.load(path))
        current = markdown.extract_block(text, name)
        if current is None:      # begin marker without a matching end
            print(f"[repro_torch.eval] docs block {name!r} has a begin "
                  f"marker but no end marker in {args.docs_path}",
                  file=sys.stderr)
            return 1
        # byte-exact against what inject_block would write, so --check
        # passing guarantees `docs` is a no-op
        if current != "\n" + rendered:
            drift.append(name)
        text = markdown.inject_block(text, name, rendered)
    if args.check:
        if drift:
            print(f"[repro_torch.eval] docs drift in blocks: {drift} (run "
                  f"`python -m repro_torch.eval docs` to update)")
            return 1
        print("[repro_torch.eval] docs tables match regenerated artifacts")
        return 0
    args.docs_path.write_text(text)
    print(f"[repro_torch.eval] updated {args.docs_path} "
          f"({'no changes' if not drift else 'blocks: ' + ', '.join(drift)})")
    return 0


def _cmd_backends(args) -> int:
    from repro_torch.quant.matmul import backend_notes
    for name, note in backend_notes().items():
        print(f"{name:24s} {note}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    return {"run": _cmd_run, "render": _cmd_render, "docs": _cmd_docs,
            "backends": _cmd_backends}[args.command](args)
