"""`orion-tpu-torch test-db` — top-level alias for `db test` (port of
``orion_tpu/cli/test_db_cmd.py``).

Capability parity: reference `src/orion/core/cli/test_db.py` keeps the
historical `orion test-db` spelling alongside `orion db test`; both run the
staged presence / creation / operations storage checks.
"""

from orion_tpu_torch.cli.db import _common, main_test


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "test-db", help="run staged storage checks (alias for `db test`)"
    )
    _common(parser)
    parser.set_defaults(func=main_test)
    return parser
