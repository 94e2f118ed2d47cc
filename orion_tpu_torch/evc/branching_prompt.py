"""Interactive conflict-resolution shell (port of
``orion_tpu/evc/branching_prompt.py``).

Capability parity: reference
`src/orion/core/io/interactive_commands/branching_prompt.py` — a `cmd.Cmd`
session offering name/add/remove/rename/code/commandline/config/algo/status/
diff/reset/auto commands with tab completion over conflicting dimension
names; `commit` exits once everything is resolved.
"""

import cmd

from orion_tpu_torch.evc import conflicts as C


class BranchingPrompt(cmd.Cmd):
    intro = (
        "Experiment configuration conflicts detected.\n"
        "Type 'status' to list them, 'help' for commands, 'auto' to resolve "
        "automatically, 'commit' when done."
    )
    prompt = "(branch) "

    def __init__(self, builder):
        super().__init__()
        self.builder = builder

    # --- inspection -----------------------------------------------------------
    def do_status(self, _line):
        """List conflicts and their resolution state."""
        from orion_tpu_torch.utils.diff import colorize_diff_line

        for conflict in self.builder.conflicts.conflicts:
            mark = "resolved" if conflict.is_resolved else "PENDING "
            print(f"  [{mark}] {colorize_diff_line(conflict.diff())}")

    def do_diff(self, _line):
        """Print the configuration diff (colored on a TTY)."""
        from orion_tpu_torch.utils.diff import colorize_diff_line

        for line in self.builder.conflicts.diffs():
            print(" ", colorize_diff_line(line))

    # --- resolutions ----------------------------------------------------------
    def do_name(self, line):
        """name <new_experiment_name> — branch under a different name."""
        self.builder.change_experiment_name(line.strip())

    def do_add(self, line):
        """add <dim> [default] — resolve a new dimension with a default."""
        parts = line.split()
        default = _literal(parts[1]) if len(parts) > 1 else None
        try:
            self.builder.add_dimension(parts[0], default)
        except ValueError as exc:
            # e.g. no default available — report, keep the session (and every
            # resolution already entered) alive.
            print(f"cannot resolve: {exc}")

    def do_remove(self, line):
        """remove <dim> [default] — drop a missing dimension."""
        parts = line.split()
        default = _literal(parts[1]) if len(parts) > 1 else None
        try:
            self.builder.remove_dimension(parts[0], default)
        except ValueError as exc:
            print(f"cannot resolve: {exc}")

    def do_rename(self, line):
        """rename <old> <new> — resolve a missing dimension as renamed."""
        old, new = line.split()
        self.builder.rename_dimension(old, new)

    def do_code(self, line):
        """code <noeffect|unsure|break> — classify the code change."""
        self.builder.set_code_change_type(line.strip())

    def do_commandline(self, line):
        """commandline <noeffect|unsure|break> — classify the cmdline change."""
        self.builder.set_cli_change_type(line.strip())

    def do_config(self, line):
        """config <noeffect|unsure|break> — classify the script-config change."""
        self.builder.set_script_config_change_type(line.strip())

    def do_algo(self, _line):
        """algo — accept the algorithm change."""
        for conflict in self.builder.conflicts.get([C.AlgorithmConflict]):
            conflict.try_resolve()

    def do_auto(self, _line):
        """auto — resolve everything automatically."""
        self.builder.conflicts.try_resolve_all()
        self.do_status("")

    def do_reset(self, _line):
        """reset — clear all resolutions."""
        self.builder.reset()

    # --- exit -----------------------------------------------------------------
    def do_commit(self, _line):
        """commit — finish (requires every conflict resolved)."""
        if self.builder.conflicts.are_resolved:
            return True
        print("Unresolved conflicts remain:")
        self.do_status("")
        return False

    def do_abort(self, _line):
        """abort — leave conflicts unresolved (branching will fail)."""
        return True

    def do_EOF(self, _line):
        """End of input: commit if everything is resolved, else abort —
        looping back to the prompt would spin forever on closed stdin."""
        if self.builder.conflicts.are_resolved:
            return True
        print("EOF with unresolved conflicts; aborting branch.")
        return True

    # --- completion -----------------------------------------------------------
    # Per-command candidates (reference branching_prompt.py:77-485 ships
    # complete_* methods per command): each command completes only the names
    # it can actually act on, so tab after `remove ` never offers a NEW
    # dimension it would reject.

    _CHANGE_TYPES = ("noeffect", "unsure", "break")

    def _conflict_names(self, *types):
        names = []
        for conflict in self.builder.conflicts.get(list(types) or None):
            if hasattr(conflict, "name") and not conflict.is_resolved:
                names.append(conflict.name)
        return names

    @staticmethod
    def _match(candidates, text):
        return [c for c in candidates if c.startswith(text)]

    def complete_add(self, text, _line, _begidx, _endidx):
        return self._match(self._conflict_names(C.NewDimensionConflict), text)

    def complete_remove(self, text, _line, _begidx, _endidx):
        return self._match(self._conflict_names(C.MissingDimensionConflict), text)

    def complete_rename(self, text, line, _begidx, _endidx):
        # First argument: the missing (old) name; second: the new name.
        n_args = len(line.split())
        if n_args > 2 or (n_args == 2 and not text):
            source = self._conflict_names(C.NewDimensionConflict)
        else:
            source = self._conflict_names(C.MissingDimensionConflict)
        return self._match(source, text)

    def complete_code(self, text, _line, _begidx, _endidx):
        return self._match(self._CHANGE_TYPES, text)

    complete_commandline = complete_code
    complete_config = complete_code

    def completedefault(self, text, _line, _begidx, _endidx):
        return self._match(self._conflict_names(), text)


def _literal(token):
    import ast

    try:
        return ast.literal_eval(token)
    except (ValueError, SyntaxError):
        return token
