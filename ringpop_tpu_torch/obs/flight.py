"""Source provenance for run journals.

Counterpart of ``git_commit`` in ``ringpop_tpu/obs/flight.py``: the
journal header (``sim/telemetry.TelemetryJournal``) names the commit the
run executed.  The flight recorder itself is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def git_commit(repo: str = _REPO) -> Optional[str]:
    """The commit hash of the repo's HEAD, read straight from the ``.git``
    directory (no subprocess): resolves ``HEAD`` through loose refs and
    ``packed-refs``.  None when the tree is not a git checkout — the
    journal header records that rather than guessing."""
    git_dir = os.path.join(repo, ".git")
    try:
        # worktrees/submodules: .git may be a pointer file
        if os.path.isfile(git_dir):
            with open(git_dir) as f:
                line = f.read().strip()
            if line.startswith("gitdir:"):
                git_dir = os.path.normpath(os.path.join(repo, line.split(":", 1)[1].strip()))
        # linked worktrees keep HEAD in their private gitdir but store
        # refs/packed-refs in the common dir (named by `commondir`)
        common = git_dir
        common_file = os.path.join(git_dir, "commondir")
        if os.path.isfile(common_file):
            with open(common_file) as f:
                common = os.path.normpath(os.path.join(git_dir, f.read().strip()))
        with open(os.path.join(git_dir, "HEAD")) as f:
            head = f.read().strip()
        if not head.startswith("ref:"):
            return head or None  # detached HEAD: the hash itself
        ref = head.split(":", 1)[1].strip()
        for base in (git_dir, common):
            loose = os.path.join(base, *ref.split("/"))
            if os.path.exists(loose):
                with open(loose) as f:
                    return f.read().strip() or None
        packed = os.path.join(common, "packed-refs")
        if os.path.exists(packed):
            with open(packed) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith(("#", "^")):
                        sha, _, name = line.partition(" ")
                        if name == ref:
                            return sha
        return None
    except OSError:
        return None
