"""Call-tree root: ``_suggest_step`` reaches the other module's helpers
through a ``from`` import, a module alias and a re-export."""

import capture_tree_helpers as helpers

from capture_tree_helpers import fit, reexported


def _suggest_step(x, y, *, steps):
    state = fit(x, y, steps=steps)
    return helpers.acquire(state), reexported(x)
