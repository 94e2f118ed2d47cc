"""Lint fixture: runtime-edge feedback into the static lock graph (LCK003).

Never imported — linted as source by tests/test_torch_lock_rules.py (through both packages), with a
runtime-edge report supplied via ``sanitizer.set_lint_runtime_edges`` (the
table test runs WITHOUT edges, where LCK003 must stay silent — this file
is therefore excluded from the plain annotation table and driven by
``test_lck003_fires_on_runtime_edge_the_static_graph_lacks``).

This pins the FIRST runtime-discovered edge the sanitizer fed back from
dogfooding the real tree: ``DBServer._persist_lock -> MemoryDB._lock`` in
``storage/netdb.py``'s snapshot flusher.  The inner lock lives on an
attribute-held object (``self.db._lock``) — a shape the static resolver
cannot follow, so the edge exists only at runtime; LCK003 is the loop that
surfaces it.  The mirror below reproduces that exact shape.
"""

import threading


class Store:
    def __init__(self):
        self._lock = threading.RLock()
        self.rows = []

    def write(self, row):
        with self._lock:
            self.rows.append(row)


class Server:
    def __init__(self):
        self._persist_lock = threading.Lock()
        self.db = Store()

    def flush(self):
        with self._persist_lock:
            # The static resolver cannot see self.db._lock (a lock reached
            # through an attribute-held object): this edge only exists in
            # the runtime-observed graph.
            with self.db._lock:  # expect: LCK003
                return list(self.db.rows)

    def nested_known(self):
        # A statically-visible nesting: the runtime report also carries
        # this edge, but the static graph already has it — no finding.
        with self._persist_lock:
            with OTHER:
                return None


OTHER = threading.Lock()
