"""`orion-tpu-torch insert`: manually register a trial at fixed parameter
values (port of ``orion_tpu/cli/insert.py``).

Capability parity: reference `src/orion/core/cli/insert.py` — values given
as ``name=value`` args, validated against the experiment's space; dimensions
with a default may be omitted.
"""

import re

from orion_tpu_torch.cli.base import add_experiment_args, build_from_args
from orion_tpu_torch.client.manual import insert_trials
from orion_tpu_torch.space.dims import NotSet

ASSIGN_RE = re.compile(r"^(?P<name>[\w\-/\.]+)=(?P<value>.*)$")


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "insert", help="insert a trial with fixed values (name=value ...)"
    )
    add_experiment_args(parser)
    parser.set_defaults(func=main)
    return parser


def parse_assignments(user_args, space):
    params = {}
    for token in user_args:
        match = ASSIGN_RE.match(token)
        if not match:
            raise ValueError(
                f"Bad assignment {token!r}; expected name=value"
            )
        name = match.group("name")
        if not name.startswith("/"):
            name = "/" + name
        if name not in space.keys():
            raise ValueError(
                f"Unknown dimension {name!r}; space has {space.keys()}"
            )
        dim = space[name]
        params[name] = dim.cast(match.group("value"))
    # Fill defaults for unspecified dims (reference `cli/insert.py:57-86`);
    # fidelity dims default to their maximum budget.
    from orion_tpu_torch.space.dims import Fidelity

    for dim in space:
        if dim.name in params:
            continue
        if isinstance(dim, Fidelity):
            params[dim.name] = dim.high
        elif dim.default_value is NotSet:
            raise ValueError(
                f"Dimension {dim.name!r} has no default and was not given"
            )
        else:
            params[dim.name] = dim.default_value
    return params


def main(args):
    experiment, _parser = build_from_args(args, allow_create=False)
    if experiment.space is None:
        raise ValueError(f"experiment {experiment.name!r} has no search space")
    params = parse_assignments(args.user_args, experiment.space)
    insert_trials(experiment, [params])
    print(f"Inserted 1 trial into {experiment.name} (v{experiment.version})")
    return 0
