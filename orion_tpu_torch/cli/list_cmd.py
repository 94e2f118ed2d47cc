"""`orion-tpu-torch list`: print the forest of experiments and their EVC
trees (port of ``orion_tpu/cli/list_cmd.py``).

Capability parity: reference `src/orion/core/cli/list.py` + `utils/pptree.py`
— each root experiment printed as an ASCII tree of its versions/branches.
"""

from orion_tpu_torch.cli.base import add_experiment_args, load_cli_config
from orion_tpu_torch.evc.experiment import ExperimentNode
from orion_tpu_torch.storage.base import setup_storage


def add_subparser(subparsers):
    parser = subparsers.add_parser("list", help="list experiments as EVC trees")
    add_experiment_args(parser, with_user_args=False)
    parser.set_defaults(func=main)
    return parser


def print_tree(node, prefix="", is_last=True, is_root=True, out=print):
    connector = "" if is_root else ("└── " if is_last else "├── ")
    out(f"{prefix}{connector}{node.tree_name()}")
    children = node.children
    child_prefix = prefix if is_root else prefix + ("    " if is_last else "│   ")
    for i, child in enumerate(children):
        print_tree(child, child_prefix, i == len(children) - 1, is_root=False, out=out)


def main(args):
    config = load_cli_config(args)
    storage = setup_storage(config["storage"], force=True)
    query = {}
    if config.get("name"):
        query["name"] = config["name"]
    experiments = storage.fetch_experiments(query)
    roots = [
        e for e in experiments if not (e.get("refers") or {}).get("parent_id")
    ]
    if not roots and experiments:
        roots = experiments  # orphaned branches: list them flat
    for doc in sorted(roots, key=lambda e: (e["name"], e.get("version", 1))):
        print_tree(ExperimentNode(storage, doc))
    if not experiments:
        print("No experiment found")
    return 0
