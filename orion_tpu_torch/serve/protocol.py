"""Gateway wire protocol: framing, ops, and error taxonomy (port of
``orion_tpu/serve/protocol.py``; the wire is the reference's, byte for byte).

The gateway speaks the same newline-delimited JSON framing as the netdb
wire (one request line, one response line, 64MB line cap, torn lines
dropped rather than dispatched) — the framing helpers are shared with
``storage/netdb.py`` so the two wire surfaces cannot drift on the
truncation contract the client-side resend logic depends on.

Response envelope: ``{"ok": true, "result": ...}`` on success;
``{"ok": false, "error": NAME, "message": ...}`` on refusal, with two
structured refusals the client handles specially:

- ``RetryAfter`` (+ ``retry_after`` seconds): backpressure — the bounded
  queue or a per-tenant quota refused admission; NOTHING ran.  The client
  honors the hint, then surfaces a transient :class:`RetryAfterError` so
  the unified retry policy re-asks with its own jittered backoff on top.
- ``UnknownTenant``: the gateway does not know this tenant (restart
  without ``--persist``, or an eviction).  Fatal to the retry policy —
  blind resends can never converge — and handled one level up:
  :class:`~orion_tpu_torch.serve.client.RemoteAlgorithm` re-attaches and
  replays its client-side observation log, then re-asks.
"""

# Shared framing (deliberately the netdb helpers, not a copy): newline
# framing + the torn-line-is-dropped rule are load-bearing for the
# send-phase resend contract on BOTH wire surfaces.
from orion_tpu_torch.storage.netdb import (  # noqa: F401
    _MAX_LINE as MAX_LINE,
    _dumps as dumps_line,
    _read_line as read_line,
)
from orion_tpu_torch.utils.exceptions import DatabaseError

#: Ops a gateway client may invoke — anything else is rejected (the wire
#: protocol is not a generic RPC surface; same rule as netdb's _DB_OPS).
#: The fleet ops: ``fleet`` (membership/occupancy probe — the `top --all`
#: header and the router's bootstrap), ``fleet_set`` (operator membership
#: change; triggers handoffs), ``handoff_import`` (gateway→gateway tenant
#: state transfer during a handoff).
GATEWAY_OPS = frozenset(
    {
        "ping", "stats", "attach", "detach", "suggest", "observe",
        "register", "fleet", "fleet_set", "handoff_import",
    }
)


class GatewayError(RuntimeError):
    """Semantic gateway refusal (bad op, over-quota q, malformed payload).

    Deliberately NOT a DatabaseError: the unified retry policy classifies
    it fatal, so a structurally-broken request fails fast instead of
    burning the backoff budget re-sending the same refusal."""


class UnknownTenantError(GatewayError):
    """The gateway has no state for this tenant — re-attach + replay."""


class WrongGatewayError(GatewayError):
    """This tenant belongs to ANOTHER fleet member (the ring says so, or
    a completed handoff left a moved-tombstone here).  Fatal to the retry
    policy — re-sending to the wrong member can never converge — and
    handled one level up: the fleet-aware client adopts the reply's
    authoritative membership (``addresses`` + ``epoch``) and re-resolves.
    """

    def __init__(self, message, owner=None, addresses=None, epoch=0):
        super().__init__(message)
        self.owner = owner
        self.addresses = list(addresses or ())
        self.epoch = int(epoch or 0)


class RetryAfterError(DatabaseError):
    """Backpressure refusal.  Transient by classification (DatabaseError
    family) and safe to re-ask in every mode: admission control refused the
    request BEFORE anything ran, so ``maybe_applied`` is always False.
    ``retry_after`` carries the gateway's pacing hint in seconds."""

    def __init__(self, message, retry_after=0.05):
        super().__init__(message)
        self.retry_after = float(retry_after)
        self.maybe_applied = False


def error_reply(error, message, **extra):
    out = {"ok": False, "error": error, "message": message}
    out.update(extra)
    return out


def ok_reply(result):
    return {"ok": True, "result": result}
