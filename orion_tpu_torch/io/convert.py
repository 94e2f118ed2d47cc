"""Config-file converters: parse user script config templates (a copy of
``orion_tpu/io/convert.py``).

Capability parity: reference `src/orion/core/io/convert.py` — YAML and JSON
converters plus a generic regex-based templater for arbitrary text configs,
selected by file extension.  A converter turns a config file into a flat
``{namespace: value}`` dict and can regenerate a concrete file from one.
"""

import json
import os
import re

import yaml


def _flatten_ns(nested, prefix=""):
    """Flatten nested config into /-namespaced keys (reference convention)."""
    out = {}
    for key, value in nested.items():
        full = f"{prefix}/{key}"
        if isinstance(value, dict) and value:
            out.update(_flatten_ns(value, prefix=full))
        else:
            out[full] = value
    return out


def _unflatten_ns(flat):
    # Split on "/" directly — keys containing a literal "." (e.g. "opt.lr")
    # must survive the round trip unrestructured.
    out = {}
    for key, value in flat.items():
        parts = key.lstrip("/").split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


class YAMLConverter:
    extensions = (".yml", ".yaml")

    def parse(self, path):
        with open(path) as handle:
            data = yaml.safe_load(handle) or {}
        return _flatten_ns(data)

    def generate(self, path, flat):
        with open(path, "w") as handle:
            yaml.safe_dump(_unflatten_ns(flat), handle, default_flow_style=False)


class JSONConverter:
    extensions = (".json",)

    def parse(self, path):
        with open(path) as handle:
            data = json.load(handle)
        return _flatten_ns(data)

    def generate(self, path, flat):
        with open(path, "w") as handle:
            json.dump(_unflatten_ns(flat), handle, indent=2)


class GenericConverter:
    """Regex templating over arbitrary text configs.

    Finds ``name~prior`` occurrences (reference `convert.py` GenericConverter),
    remembers the surrounding text as a template, and substitutes concrete
    values on generate.
    """

    extensions = ()
    # Expression alternatives, first match wins: a (possibly marked) call
    # form whose parentheses may contain spaces/quotes
    # (``lr~loguniform(1e-4, 1e-1)``, ``act~+choices(['relu', 'tanh'])``),
    # the remove marker ``x~-``, the rename marker ``x~>new_name``, or a
    # bare token.  Truncating at whitespace (the previous rule) silently
    # dropped everything after the first space inside the parentheses —
    # the reference's regex (`convert.py:158`) deliberately spans to the
    # closing parenthesis for the same reason.
    # The marker alternatives need boundaries: a bare "-" must not eat the
    # front of "-5" (old bare-token capture), and ">name" must span
    # hyphenated names or "m~>new-name" would template a dangling "-name".
    # The call-form parentheses allow ONE level of nesting
    # (``choices([(1, 2), (3, 4)])``) instead of stopping at the first ``)``;
    # a fully greedy ``\(.*\)`` (the reference's rule, `convert.py:158`)
    # would instead swallow a second ``name~prior(...)`` on the same line.
    PRIOR_RE = re.compile(
        r"([\w\.\-/]+)~([+]?[\w.]+\((?:[^()]|\([^()]*\))*\)|-(?![\w.\-])|>[\w.\-]+|[^\s'\"]+)"
    )

    def __init__(self):
        self._template = None

    def parse(self, path):
        with open(path) as handle:
            text = handle.read()
        flat = {}

        def repl(match):
            name, expr = match.groups()
            ns = "/" + name.lstrip("/")
            flat[ns] = "~" + expr
            return "{" + ns + "}"

        self._template = self.PRIOR_RE.sub(repl, text)
        return flat

    def generate(self, path, flat):
        if self._template is None:
            raise RuntimeError("GenericConverter.generate before parse")
        text = self._template
        for ns, value in flat.items():
            text = text.replace("{" + ns + "}", str(value))
        with open(path, "w") as handle:
            handle.write(text)


def infer_converter(path):
    ext = os.path.splitext(path)[1].lower()
    for cls in (YAMLConverter, JSONConverter):
        if ext in cls.extensions:
            return cls()
    return GenericConverter()
