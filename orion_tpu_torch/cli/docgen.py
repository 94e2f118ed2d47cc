"""Generate the port's command reference (``docs/torch_commands.md``) from
the live argparse tree (port of ``orion_tpu/cli/docgen.py``), so the docs
can never drift from the code: every command's section IS its ``--help``
output, and a test regenerates the text and fails when the checked-in
copy is stale.

Run as ``python -m orion_tpu_torch.cli.docgen [output-path]``.
"""

import argparse

DEFAULT_OUT = "docs/torch_commands.md"


def _subparsers_of(parser):
    """name -> subparser mapping, or {} when the parser has none."""
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            # `choices` maps aliases to the same object; keep first name only.
            seen, out = set(), {}
            for name, sub in action.choices.items():
                if id(sub) not in seen:
                    seen.add(id(sub))
                    out[name] = sub
            return out
    return {}


def _command_section(name, parser, depth):
    title = "#" * depth + f" `{name}`"
    help_text = parser.format_help().rstrip()
    lines = [title, "", "```text", help_text, "```", ""]
    for sub_name, sub in sorted(_subparsers_of(parser).items()):
        lines.append(_command_section(f"{name} {sub_name}", sub, depth + 1))
    return "\n".join(lines)


def generate_markdown():
    import os

    from orion_tpu_torch.cli import build_parser

    # argparse wraps help to the terminal width; pin it so the generated
    # file is identical no matter where it is regenerated.
    prev = os.environ.get("COLUMNS")
    os.environ["COLUMNS"] = "80"
    try:
        return _render(build_parser())
    finally:
        if prev is None:
            os.environ.pop("COLUMNS", None)
        else:
            os.environ["COLUMNS"] = prev


def _render(parser):
    parts = [
        "# Command reference (orion-tpu-torch)",
        "",
        "Generated from the live argparse tree by `python -m"
        " orion_tpu_torch.cli.docgen` — do not edit by hand"
        " (`tests/test_torch_lint_cli.py` fails when this file is stale).",
        "",
        "```text",
        parser.format_help().rstrip(),
        "```",
        "",
    ]
    for name, sub in sorted(_subparsers_of(parser).items()):
        parts.append(_command_section(name, sub, 2))
    return "\n".join(parts).rstrip() + "\n"


def main(argv=None):
    import sys

    argv = list(argv if argv is not None else sys.argv[1:])
    out_path = argv[0] if argv else DEFAULT_OUT
    text = generate_markdown()
    with open(out_path, "w") as handle:
        handle.write(text)
    print(f"wrote {out_path} ({len(text.splitlines())} lines)")


if __name__ == "__main__":
    main()
