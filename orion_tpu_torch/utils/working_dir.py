"""Per-trial working directory context manager (a copy of
``orion_tpu/utils/working_dir.py``).

Capability parity: reference `src/orion/core/utils/working_dir.py` — a
permanent directory (created under the experiment working dir, kept) or a
self-cleaning temporary directory per trial.
"""

import os
import shutil
import tempfile


class WorkingDir:
    def __init__(self, working_dir=None, temp=None, suffix="", prefix="trial-"):
        self.working_dir = working_dir
        self.temp = temp if temp is not None else working_dir is None
        self.suffix = suffix
        self.prefix = prefix
        self.path = None

    def __enter__(self):
        if self.temp:
            self.path = tempfile.mkdtemp(
                suffix=self.suffix, prefix=self.prefix, dir=self.working_dir
            )
        else:
            self.path = os.path.join(self.working_dir, self.prefix + self.suffix)
            os.makedirs(self.path, exist_ok=True)
        return self.path

    def __exit__(self, exc_type, exc_value, traceback):
        if self.temp and self.path:
            shutil.rmtree(self.path, ignore_errors=True)
