"""Colored terminal diffs for the branching flow (port of
``orion_tpu/utils/diff.py``).

Capability parity: reference `src/orion/core/utils/diff.py` (red/green
ANSI-colored diff lines shown during conflict resolution).  Colors engage
only on a TTY and honor the NO_COLOR convention — branching output is also
consumed by tests and scripted sessions, which must see plain text.
"""

import os
import sys

_RESET = "\x1b[0m"
_COLORS = {
    "+": "\x1b[0;32m",  # additions: green
    "-": "\x1b[0;31m",  # removals: red
    "~": "\x1b[0;33m",  # changes: yellow
    ">": "\x1b[0;36m",  # renames: cyan
}


def color_enabled(stream=None):
    stream = stream if stream is not None else sys.stdout
    if os.environ.get("NO_COLOR"):
        return False
    return bool(getattr(stream, "isatty", lambda: False)())


def colorize_diff_line(line, stream=None):
    """Color one conflict diff line by its leading marker (+/-/~/>)."""
    if not color_enabled(stream):
        return line
    code = _COLORS.get(line[:1])
    if code is None:
        return line
    return f"{code}{line}{_RESET}"
