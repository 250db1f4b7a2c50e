"""The port's analysis stage from the command line.

    python -m mxnet_tpu_torch.analysis                  # mxnet_tpu_torch/
    python -m mxnet_tpu_torch.analysis PATH ...         # these files/dirs
    python -m mxnet_tpu_torch.analysis --diff HEAD~1    # changed files only
    python -m mxnet_tpu_torch.analysis --write-baseline # grandfather hits

Runs the rules of ``linter.py`` (the style stage is ``tools/lint.py``'s).
Known findings live in ``mxnet_tpu_torch/analysis/lint_baseline.json``
(``--baseline`` or ``MXNET_LINT_BASELINE`` overrides; a missing file is
an empty baseline); only NEW findings fail.  Exit 0 clean, 1 with
findings listed.
"""
import argparse
import os
import subprocess
import sys

from ..base import get_env
from . import linter

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
DEFAULT_BASELINE = os.path.join(PKG, "analysis", "lint_baseline.json")


def _diff_paths(rev):
    """The port's .py files changed since ``rev``: committed, staged,
    worktree and untracked (a brand-new module is what a pre-commit lint
    must see), that still exist."""
    out = subprocess.run(["git", "diff", "--name-only", rev, "--"],
                         cwd=ROOT, capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit("lint: git diff %s failed: %s"
                         % (rev, out.stderr.strip()))
    names = out.stdout.splitlines()
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        cwd=ROOT, capture_output=True, text=True)
    if untracked.returncode == 0:
        names += untracked.stdout.splitlines()
    paths = []
    for line in sorted(set(n.strip() for n in names)):
        p = os.path.join(ROOT, line)
        if line.startswith("mxnet_tpu_torch/") and line.endswith(".py") \
                and os.path.exists(p):
            paths.append(p)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis",
        description="The port's analysis stage (linter.py's rules).")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: mxnet_tpu_torch/)")
    ap.add_argument("--diff", metavar="REV",
                    help="lint only the port's files changed since REV")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default %s or $MXNET_LINT_BASELINE)"
                    % os.path.relpath(DEFAULT_BASELINE, ROOT))
    ap.add_argument("--write-baseline", action="store_true",
                    help="record the current findings as the baseline "
                    "and exit")
    args = ap.parse_args(argv)
    if args.diff:
        if args.paths:
            ap.error("--diff and explicit paths are mutually exclusive")
        paths = _diff_paths(args.diff)
    elif args.paths:
        paths = [os.path.abspath(p) for p in args.paths]
    else:
        paths = [PKG]
    findings = linter.lint_paths(paths, ROOT)
    baseline_path = (args.baseline or get_env("MXNET_LINT_BASELINE")
                     or DEFAULT_BASELINE)
    if args.write_baseline:
        linter.Baseline(set()).save(baseline_path, findings)
        print("lint: baseline written to %s (%d finding(s) grandfathered)"
              % (os.path.relpath(baseline_path, ROOT), len(findings)))
        return 0
    findings = linter.load_baseline(baseline_path).new_findings(findings)
    for f in findings:
        print(f)
    print("lint: %d finding(s) in %d path(s)" % (len(findings), len(paths)))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
