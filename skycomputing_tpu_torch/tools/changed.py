"""Changed-file discovery for the ``--changed-only`` mode of the port's
skylint, skyaudit and skydet (the port's own copy of
``tools/changed.py``).

Pure stdlib (subprocess + git): a pre-commit run should check the files
the commit touches, in milliseconds, without scanning the tree.  The
contract the CLIs share:

- files named explicitly on argv are the change set, verbatim;
- otherwise the set is what git reports as modified (worktree +
  index) plus untracked files, filtered to ``*.py`` under the given
  directories;
- no git / not a repo -> ``None`` (callers fall back to a full run
  rather than silently lint nothing).
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Sequence


def _git_lines(args: List[str], cwd: str) -> Optional[List[str]]:
    try:
        proc = subprocess.run(
            ["git"] + args, cwd=cwd, capture_output=True, text=True,
            timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    return [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]


def changed_python_files(
    paths: Sequence[str],
    cwd: str = ".",
) -> Optional[List[str]]:
    """The ``.py`` files a local lint run should cover.

    ``paths`` is the CLI's positional argument list: explicit FILES in
    it win outright (the caller named the change set); DIRECTORIES in
    it scope the git-derived set.  Returns ``None`` when git is
    unavailable (caller decides the fallback), ``[]`` when nothing
    relevant changed.
    """
    explicit = [p for p in paths if os.path.isfile(p)]
    if explicit:
        return sorted(set(explicit))
    dirs = [os.path.abspath(p) for p in paths if os.path.isdir(p)]

    modified = _git_lines(["diff", "--name-only", "HEAD"], cwd)
    if modified is None:
        return None
    untracked = _git_lines(
        ["ls-files", "--others", "--exclude-standard"], cwd) or []
    top = _git_lines(["rev-parse", "--show-toplevel"], cwd)
    root = top[0] if top else os.path.abspath(cwd)

    out: List[str] = []
    for rel in modified + untracked:
        if not rel.endswith(".py"):
            continue
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            continue  # deleted files cannot be linted
        if dirs and not any(
                os.path.abspath(path).startswith(d + os.sep)
                for d in dirs):
            continue
        out.append(path)
    return sorted(set(out))


__all__ = ["changed_python_files"]
