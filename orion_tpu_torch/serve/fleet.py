"""Gateway fleet: consistent-hash tenant routing + zero-loss handoff (port
of ``orion_tpu/serve/fleet.py``: the same ring, so a port client and a
reference client place a tenant on the same member).

One gateway process owns one device — the fleet is how suggest serving
scales past it.  The machinery is the storage layer's,
lifted one plane up:

- **Placement** is the storage router's :class:`~orion_tpu_torch.storage.shard.HashRing`
  (64 md5 vnodes per member) over the SORTED fleet address list.  Every
  client and every gateway builds the identical ring from the identical
  membership — the ring IS the agreement; there is no coordinator.  The
  ring key is the tenant's experiment identity (``name-vVERSION``, the
  part before the ``@worker`` suffix), so every worker of one experiment
  lands on the same gateway and keeps coalescing with itself.
- **Handoff** is the storage rebalancer's placement-override phases reshaped for
  tenant state: pinned (the holder serves, whatever the ring says) →
  fenced (RETRY-AFTER, never a fork) → moved (a tombstone answering
  ``WrongGateway`` with the authoritative membership).  The state that
  moves is the gateway's persist snapshot — ``state_dict`` carries history,
  trust-region box AND the RNG stream, so a migrated tenant's suggestion
  stream continues bit-identically.
- **Durability** is a :class:`TenantStore`: one pickle file per tenant in
  a (shared) persist directory, written atomically BEFORE a fleet
  gateway releases the round's replies — so the snapshot a survivor
  restores is never behind anything a client saw acknowledged, and a
  mid-stream gateway kill costs a failover, not a fork.

Client side, :class:`FleetRouter` keeps one
:class:`~orion_tpu_torch.serve.client.GatewayClient` (its own connection, its
own retry policy) per member, so one dead gateway never serializes the
rest; a member that exhausts its policy is marked down for a cooldown and
the ring re-resolves over the survivors (the gateway admits the resulting
off-ring attach only when the client declares the takeover explicitly —
see ``docs/serving.md`` for the who-wins matrix).
"""

import hashlib
import logging
import os
import pickle
import threading
import time

from orion_tpu_torch.storage.backends import atomic_pickle_dump
from orion_tpu_torch.storage.shard import DEFAULT_VNODES, HashRing
from orion_tpu_torch.utils.exceptions import DatabaseError

log = logging.getLogger(__name__)

#: Re-resolve bound for one logical op: adopt-membership hops plus
#: mark-down failovers.  Deliberately small — a routing loop longer than
#: this is a misconfigured fleet, not a transient.
FLEET_MAX_HOPS = 8

#: Seconds a marked-down member stays out of the client-side ring before
#: the router re-admits it (one failed policy run per cooldown is the
#: price of probing a still-dead gateway).
DOWN_COOLDOWN_S = 5.0

#: Fleet clients default to a TIGHTER per-gateway policy than the single
#: gateway's ride-out-the-restart default: with survivors to fail over
#: to, burning a 60s deadline on a dead member is the worse trade.
FLEET_RETRY_DEFAULTS = {"max_attempts": 4, "deadline": 10.0, "base_delay": 0.05}

#: Fenced-tenant age (seconds) past which a handoff counts as STUCK —
#: the DX008 doctor threshold and the gateway's own alarm gauge horizon.
HANDOFF_TTL_S = 30.0


def ring_key(tenant):
    """The placement key for a tenant id.

    Tenant ids are ``name-vVERSION@host:pid`` (one per worker process);
    placement strips the worker suffix so every worker of one experiment
    routes to the same gateway — co-placed workers coalesce, and a
    handoff moves the whole experiment at once."""
    return str(tenant).split("@", 1)[0]


def normalize_address(address, default_port=8777):
    """``host[:port]`` -> canonical ``host:port`` string."""
    host, _, port = str(address).partition(":")
    return f"{host or '127.0.0.1'}:{int(port) if port else default_port}"


def parse_serve_addresses(serve_config):
    """The fleet address list from a ``serve:`` config section.

    ``addresses`` (list or comma-separated string) wins over the single
    ``address``; entries are normalized and de-duplicated with order
    preserved.  A one-element result means single-gateway mode."""
    serve_config = serve_config or {}
    raw = serve_config.get("addresses")
    if raw is None:
        raw = [serve_config.get("address", "127.0.0.1:8777")]
    elif isinstance(raw, str):
        raw = [piece for piece in raw.split(",") if piece.strip()]
    addresses = []
    for entry in raw:
        normalized = normalize_address(str(entry).strip())
        if normalized not in addresses:
            addresses.append(normalized)
    if not addresses:
        raise DatabaseError("serve.addresses resolved to an empty fleet")
    return addresses


class FleetState:
    """One fleet membership epoch: the SORTED address tuple + the ring.

    Sorting is load-bearing: every party that learns the same member SET
    must compute the same ring regardless of the order it learned the
    addresses in (config file vs ``WrongGateway`` reply vs ``--fleet``
    flag)."""

    def __init__(self, addresses, epoch=0, vnodes=DEFAULT_VNODES):
        self.addresses = tuple(sorted({normalize_address(a) for a in addresses}))
        if not self.addresses:
            raise DatabaseError("a gateway fleet needs at least one member")
        self.epoch = int(epoch)
        self._ring = HashRing(self.addresses, vnodes=vnodes)

    def owner(self, key):
        """The member address owning ``key`` (a :func:`ring_key`)."""
        return self.addresses[self._ring.lookup(key)]

    def index_of(self, address):
        """The member's stable gauge index (``serve.fleet.tenants.g{i}``):
        its position in the sorted membership."""
        return self.addresses.index(normalize_address(address))

    def to_wire(self):
        return {"addresses": list(self.addresses), "epoch": self.epoch}


class TenantStore:
    """Per-tenant snapshot files in a persist directory.

    One atomic pickle per tenant (the tempfile+rename discipline,
    sliced per tenant so a fleet gateway can write ONLY the round's dirty
    tenants before releasing the round's replies).  Filenames are the
    md5 of the tenant id — ids carry ``@host:pid`` — with the real name
    stored inside the payload, so a boot-time scan can re-key the
    directory without trusting the filesystem encoding."""

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name):
        digest = hashlib.md5(str(name).encode("utf-8")).hexdigest()
        return os.path.join(self.root, f"tenant-{digest}.pkl")

    def save(self, name, snapshot):
        atomic_pickle_dump(
            self._path(name), {"tenant": str(name), "snapshot": snapshot}
        )

    def load(self, name):
        """The stored snapshot for ``name``, or None (missing/corrupt —
        a torn write cannot happen by construction, but a partial disk is
        a restore miss, never a crash)."""
        try:
            with open(self._path(name), "rb") as handle:
                payload = pickle.load(handle)
        except FileNotFoundError:
            return None
        except Exception:  # pragma: no cover - corrupt snapshot file
            log.exception("could not load tenant snapshot for %r", name)
            return None
        return payload.get("snapshot")

    def delete(self, name):
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass

    def items(self):
        """Yield ``(tenant_name, snapshot)`` for every stored tenant —
        the boot-time restore scan."""
        try:
            entries = sorted(os.listdir(self.root))
        except FileNotFoundError:  # pragma: no cover - root raced away
            return
        for entry in entries:
            if not (entry.startswith("tenant-") and entry.endswith(".pkl")):
                continue
            try:
                with open(os.path.join(self.root, entry), "rb") as handle:
                    payload = pickle.load(handle)
                yield str(payload["tenant"]), payload["snapshot"]
            except Exception:  # pragma: no cover - corrupt snapshot file
                log.exception("skipping unreadable tenant snapshot %s", entry)


class FleetRouter:
    """Client-side fleet view: per-member clients, liveness, the ring.

    ``client_factory(address)`` builds the per-member
    :class:`~orion_tpu_torch.serve.client.GatewayClient` lazily — each member
    gets its OWN connection and its OWN retry policy, so a dead member
    costs its own policy's deadline once, not every request's.
    """

    def __init__(self, addresses, client_factory, epoch=0,
                 vnodes=DEFAULT_VNODES, down_cooldown=DOWN_COOLDOWN_S):
        self._client_factory = client_factory
        self._vnodes = vnodes
        self._down_cooldown = float(down_cooldown)
        self._lock = threading.Lock()
        self._clients = {}
        self._down = {}  # address -> monotonic mark-down time
        self._state = FleetState(addresses, epoch=epoch, vnodes=vnodes)
        self.failovers = 0
        self.adoptions = 0

    @property
    def epoch(self):
        return self._state.epoch

    @property
    def addresses(self):
        return self._state.addresses

    def client(self, address):
        address = normalize_address(address)
        with self._lock:
            client = self._clients.get(address)
            if client is None:
                client = self._clients[address] = self._client_factory(address)
            return client

    def resolve(self, key):
        """``(owner_address, takeover)`` for a ring key.

        The ring is computed over LIVE members only; ``takeover`` is True
        when the full-membership owner is currently marked down — the
        client must then declare the off-ring attach explicitly, or the
        fallback gateway (which still believes the owner alive) would
        answer ``WrongGateway`` and the pair would bounce forever."""
        with self._lock:
            state = self._state
            now = time.monotonic()
            for address, since in list(self._down.items()):
                if now - since >= self._down_cooldown:
                    del self._down[address]  # cooldown over: re-probe it
            live = [a for a in state.addresses if a not in self._down]
        if not live or len(live) == len(state.addresses):
            return state.owner(key), False
        full_owner = state.owner(key)
        live_owner = FleetState(live, epoch=state.epoch,
                                vnodes=self._vnodes).owner(key)
        return live_owner, live_owner != full_owner

    def mark_down(self, address):
        with self._lock:
            self._down[normalize_address(address)] = time.monotonic()
            self.failovers += 1

    def mark_up(self, address):
        with self._lock:
            self._down.pop(normalize_address(address), None)

    def adopt(self, addresses, epoch):
        """Adopt a gateway-reported membership (a ``WrongGateway`` reply
        or a ``fleet`` probe).  Epoch-guarded: a stale gateway cannot roll
        the client back to a membership the fleet already left."""
        if not addresses:
            return False
        epoch = int(epoch or 0)
        with self._lock:
            if epoch < self._state.epoch:
                return False
            candidate = FleetState(addresses, epoch=epoch, vnodes=self._vnodes)
            if (candidate.addresses == self._state.addresses
                    and epoch == self._state.epoch):
                return False
            self._state = candidate
            self.adoptions += 1
            return True

    def close(self):
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for client in clients:
            try:
                client.close()
            except Exception:  # pragma: no cover - teardown best effort
                pass
