"""User-commandline prior extraction and templating (a copy of
``orion_tpu/io/cmdline.py``: the port imports nothing of ``orion_tpu``, and
its ``state_dict`` is stored as ``metadata.parser_state``, so the two must
agree dict for dict).

Capability parity: reference `src/orion/core/io/orion_cmdline_parser.py` +
`cmdline_parser.py`: extract priors from the user's command
(``-x~'uniform(-50, 50)'`` becomes namespace ``/x``) and from a config file
referenced by ``--config`` (templated YAML/JSON/generic), keep an
order-preserving template of the whole command, and regenerate the concrete
argv for a given trial — including per-trial instantiated config files and
``{trial.id}`` / ``{trial.working_dir}`` / ``{exp.name}`` placeholders.
"""

import copy
import os
import re

from orion_tpu_torch.io.convert import infer_converter


class CommandLineParser:
    """Parse once at experiment creation; format per trial forever after."""

    def __init__(self, config_prefix="config"):
        self.config_prefix = config_prefix
        self.template = []  # tokens: literals or {"ns": "/x"} placeholders
        self.priors = {}  # namespace -> prior expr (markers preserved)
        self.config_file_path = None
        self._config_template = {}  # namespace -> literal or prior placeholder
        self._converter = None

    # --- parsing ------------------------------------------------------------
    def parse(self, args):
        args = list(args or [])
        i = 0
        while i < len(args):
            token = args[i]
            consumed = self._parse_config_flag(args, i)
            if consumed:
                i += consumed
                continue
            self._parse_token(token)
            i += 1
        return self.priors

    def _parse_config_flag(self, args, i):
        """Handle ``--config path`` / ``-c path`` / ``--config=path``."""
        token = args[i]
        names = {f"--{self.config_prefix}", f"-{self.config_prefix[0]}"}
        path = None
        used = 0
        if token in names and i + 1 < len(args):
            path, used = args[i + 1], 2
            self.template.extend([token, {"config": True}])
        elif token.startswith(f"--{self.config_prefix}="):
            path, used = token.split("=", 1)[1], 1
            self.template.append({"config": True, "eq_flag": f"--{self.config_prefix}"})
        if path is None:
            return 0
        if self.config_file_path is not None:
            raise ValueError("Only one --config file is supported")
        self.config_file_path = os.path.abspath(path)
        self._parse_config_file(self.config_file_path)
        return used

    def _parse_config_file(self, path):
        self._converter = infer_converter(path)
        flat = self._converter.parse(path)
        for ns, value in flat.items():
            if isinstance(value, str) and value.startswith("~"):
                expr = value[1:]
                if ns in self.priors:
                    raise ValueError(f"Duplicate prior for {ns}")
                self.priors[ns] = expr
                self._config_template[ns] = {"ns": ns}
            else:
                self._config_template[ns] = value

    _NAME_RE = re.compile(r"[\w\.\-/]+")

    def _parse_token(self, token):
        """Classify one arg: dashed prior (``-x~'uniform(0,1)'``, with or
        without ``=``), positional prior (``x~prior``), or literal."""
        if "~" not in token:
            self.template.append(token)
            return
        if token.startswith("-"):
            dashes = "-" * (len(token) - len(token.lstrip("-")))
            rest = token.lstrip("-")
            left, expr = rest.split("~", 1)
            eq = left.endswith("=")
            name = left[:-1] if eq else left
            if name and self._NAME_RE.fullmatch(name):
                self._add_prior("/" + name, expr, flag=dashes + name, eq=eq)
            else:
                self.template.append(token)
            return
        left, expr = token.split("~", 1)
        if left and self._NAME_RE.fullmatch(left):
            self._add_prior("/" + left, expr, flag=None, eq=False)
        else:
            self.template.append(token)

    def _add_prior(self, ns, expr, flag=None, eq=False):
        if ns in self.priors:
            raise ValueError(f"Duplicate prior for {ns}")
        self.priors[ns] = expr
        self.template.append({"ns": ns, "flag": flag, "eq": eq})

    # --- state --------------------------------------------------------------
    def state_dict(self):
        return {
            "config_prefix": self.config_prefix,
            "template": copy.deepcopy(self.template),
            "priors": dict(self.priors),
            "config_file_path": self.config_file_path,
            "config_template": copy.deepcopy(self._config_template),
        }

    @classmethod
    def from_state(cls, state):
        parser = cls(config_prefix=state.get("config_prefix", "config"))
        parser.template = copy.deepcopy(state["template"])
        parser.priors = dict(state["priors"])
        parser.config_file_path = state.get("config_file_path")
        parser._config_template = copy.deepcopy(state.get("config_template", {}))
        if parser.config_file_path:
            parser._converter = infer_converter(parser.config_file_path)
            if hasattr(parser._converter, "PRIOR_RE") and os.path.exists(
                parser.config_file_path
            ):
                parser._converter.parse(parser.config_file_path)
        return parser

    # --- formatting ---------------------------------------------------------
    def format(self, trial, experiment=None, config_path=None):
        """Concrete argv for one trial (reference `orion_cmdline_parser.py:359`)."""
        out = []
        for token in self.template:
            if isinstance(token, str):
                out.append(self._substitute(token, trial, experiment))
                continue
            if token.get("config"):
                if config_path is None:
                    raise ValueError("Trial needs an instantiated config file path")
                if token.get("eq_flag"):
                    out.append(f"{token['eq_flag']}={config_path}")
                else:
                    out.append(config_path)
                continue
            ns = token["ns"]
            value = trial.params[ns]
            if token.get("flag") and token.get("eq"):
                out.append(f"{token['flag']}={value}")
            elif token.get("flag"):
                out.extend([token["flag"], str(value)])
            else:
                out.append(str(value))
        return out

    def generate_config(self, path, trial):
        """Write the per-trial concrete config file."""
        if self._converter is None:
            raise RuntimeError("No config file was parsed")
        flat = {}
        for ns, value in self._config_template.items():
            if isinstance(value, dict) and "ns" in value:
                flat[ns] = trial.params[value["ns"]]
            else:
                flat[ns] = value
        self._converter.generate(path, flat)

    @staticmethod
    def _substitute(token, trial, experiment):
        if "{" not in token:
            return token
        mapping = {
            "trial.id": getattr(trial, "id", ""),
            "trial.working_dir": getattr(trial, "working_dir", "") or "",
            "trial.hash_params": getattr(trial, "hash_params", ""),
            "exp.name": getattr(experiment, "name", "") if experiment else "",
        }
        for key, value in mapping.items():
            token = token.replace("{" + key + "}", str(value))
        return token

    @property
    def has_config_file(self):
        return self.config_file_path is not None
