"""Plugin registry of the port (a copy of ``orion_tpu.utils.registry``).

Capability parity with the reference's ``Factory`` metaclass + pkg_resources
entry-point discovery (`src/orion/core/utils/__init__.py:80-160`), redesigned
without metaclass magic: an explicit registry per extension kind (algorithms,
storage backends, parallel strategies, adapters, converters) that also scans
``importlib.metadata`` entry points lazily, so third-party packages can ship
algorithms by declaring an ``orion_tpu_torch.<kind>`` entry point.

The port keeps its own copy so that its entry-point group is
``orion_tpu_torch.<kind>``: under the reference's group, looking up an
unknown name would load ``orion_tpu``'s plugins and with them JAX.
"""

import importlib.metadata
import logging

log = logging.getLogger(__name__)


class Registry:
    """Named registry of classes with entry-point discovery."""

    def __init__(self, kind, entry_point_group=None):
        self.kind = kind
        self.entry_point_group = entry_point_group or f"orion_tpu_torch.{kind}"
        self._classes = {}
        self._scanned_entry_points = False

    def register(self, name=None):
        """Class decorator: ``@registry.register("random")``."""

        def deco(cls):
            key = (name or cls.__name__).lower()
            self._classes[key] = cls
            return cls

        return deco

    def add(self, name, cls):
        self._classes[name.lower()] = cls

    def _scan_entry_points(self):
        if self._scanned_entry_points:
            return
        self._scanned_entry_points = True
        try:
            eps = importlib.metadata.entry_points(group=self.entry_point_group)
        except Exception:  # pragma: no cover - metadata backend quirks
            return
        for ep in eps:
            if ep.name.lower() in self._classes:
                continue
            try:
                self._classes[ep.name.lower()] = ep.load()
            except Exception as exc:  # pragma: no cover
                log.warning("Could not load %s plugin %r: %s", self.kind, ep.name, exc)

    def get(self, name):
        key = name.lower()
        if key not in self._classes:
            self._scan_entry_points()
        if key not in self._classes:
            raise NotImplementedError(
                f"Unknown {self.kind} {name!r}. Available: {sorted(self._classes)}"
            )
        return self._classes[key]

    def create(self, name, *args, **kwargs):
        return self.get(name)(*args, **kwargs)

    def names(self):
        self._scan_entry_points()
        return sorted(self._classes)
