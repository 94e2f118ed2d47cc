"""VCS + script-config metadata capture for experiment identity (a copy of
``orion_tpu/io/versioning.py``: an experiment the reference created resumes
in the port only when both compute the same metadata).

Capability parity: reference `src/orion/core/io/resolve_config.py:249-289`
(`infer_versioning_metadata`: HEAD sha, dirty flag, active branch, diff sha
of the user script's git repository).  Implemented over subprocess git — no
gitpython dependency — and degrades to None outside a repository, so
experiments on unversioned scripts simply never raise CodeConflict.

The captured dict feeds
:func:`orion_tpu_torch.evc.conflicts.detect_conflicts`: a changed
``HEAD_sha`` (or a changed dirty-diff sha) between two hunts of the same
experiment, or a changed script-config content hash, is a conflict.
"""

import hashlib
import logging
import os
import subprocess

log = logging.getLogger(__name__)

_GIT_TIMEOUT = 10.0
#: Untracked files whose CONTENT feeds the code-identity hash (code only —
#: data/log/checkpoint files change during a hunt without being code changes).
_CODE_SUFFIXES = (".py", ".sh", ".yaml", ".yml", ".json", ".toml", ".cfg", ".ini")
_MAX_HASHED_FILE = 1 << 20  # 1 MiB


def _git(repo_dir, *argv):
    """Run git in ``repo_dir``; returns stripped stdout or None on failure."""
    try:
        result = subprocess.run(
            ["git", "-C", repo_dir, *argv],
            capture_output=True,
            text=True,
            timeout=_GIT_TIMEOUT,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        log.debug("git %s failed: %s", argv, exc)
        return None
    if result.returncode != 0:
        return None
    return result.stdout.strip()


def infer_versioning_metadata(script_path):
    """Describe the git state of the repository containing ``script_path``.

    Returns ``{"type": "git", "is_dirty", "HEAD_sha", "active_branch",
    "diff_sha"}`` or None when the script is not inside a git repository (or
    git is unavailable).  ``diff_sha`` hashes the uncommitted diff so two
    dirty checkouts at the same HEAD still compare differently when their
    edits differ (reference `resolve_config.py:270-282`).
    """
    repo_dir = os.path.dirname(os.path.abspath(script_path)) or "."
    if _git(repo_dir, "rev-parse", "--is-inside-work-tree") != "true":
        return None
    head_sha = _git(repo_dir, "rev-parse", "HEAD")
    if head_sha is None:  # fresh repo without commits
        head_sha = ""
    branch = _git(repo_dir, "rev-parse", "--abbrev-ref", "HEAD")
    status = _git(repo_dir, "status", "--porcelain")
    diff = _git(repo_dir, "diff", "HEAD") if head_sha else _git(repo_dir, "diff")
    # The working-tree hash covers the tracked diff, the status listing, AND
    # the CONTENT of untracked *code* files next to the script: `git diff
    # HEAD` is blind to untracked files and the status listing only names
    # them, but an edited untracked helper the script imports is still a
    # code change.  Only small source files are content-hashed — untracked
    # logs/checkpoints the script WRITES during a hunt must not churn the
    # code identity and force a spurious branch on every resume.
    parts = [diff or "", status or ""]
    untracked = _git(repo_dir, "ls-files", "--others", "--exclude-standard")
    for rel in (untracked or "").splitlines():
        if not rel.endswith(_CODE_SUFFIXES):
            continue
        path = os.path.join(repo_dir, rel)
        try:
            if os.path.getsize(path) > _MAX_HASHED_FILE:
                continue
            with open(path, "rb") as handle:
                parts.append(rel + hashlib.sha256(handle.read()).hexdigest())
        except OSError:
            parts.append(rel)
    dirty_state = "\0".join(parts)
    diff_sha = (
        hashlib.sha256(dirty_state.encode()).hexdigest()
        if dirty_state.strip("\0")
        else None
    )
    return {
        "type": "git",
        "is_dirty": bool(status),
        "HEAD_sha": head_sha,
        "active_branch": branch,
        "diff_sha": diff_sha,
    }


def hash_config_file(path):
    """Content hash of the user's script config file (templated YAML/JSON/...).

    Feeds ScriptConfigConflict detection: editing the config template between
    hunts must branch the experiment (reference `conflicts.py:1334`).
    """
    try:
        with open(path, "rb") as handle:
            return hashlib.sha256(handle.read()).hexdigest()
    except OSError:
        return None
