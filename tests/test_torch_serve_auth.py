"""The port's authenticated serve-gateway wire (``orion_tpu_torch.serve`` +
the shared netdb handshake), the counterpart of
``tests/unit/test_serve_auth.py``.

The gateway reuses the netdb PBKDF2/HMAC-SHA256 mutual handshake
(``storage/netdb.py``): the client proves first over per-connection
nonces, then verifies the server's proof — so a wrong secret, a missing
secret, AND a downgrade (secret-configured client against a no-auth
listener) all refuse with a fatal ``AuthenticationError`` before any
tenant data flows, on both wire surfaces identically.
"""

import pytest

from orion_tpu_torch.serve.client import GatewayClient, RemoteAlgorithm
from orion_tpu_torch.serve.gateway import GatewayServer as _GatewayServer
from orion_tpu_torch.space.dsl import build_space
from orion_tpu_torch.utils.exceptions import AuthenticationError

SECRET = "soak-wire-secret"
PRIORS = {"x0": "uniform(0, 1)"}
RETRY = {"max_attempts": 2, "base_delay": 0.01, "deadline": 3.0}


def GatewayServer(**kwargs):
    """The port's gateway on the CPU (the card is the default)."""
    return _GatewayServer(device="cpu", **kwargs)


@pytest.fixture
def auth_gateway():
    server = GatewayServer(window=0.05, max_width=4, secret=SECRET)
    server.serve_background()
    yield server
    server.shutdown()
    server.server_close()


@pytest.fixture
def open_gateway():
    server = GatewayServer(window=0.05, max_width=4)
    server.serve_background()
    yield server
    server.shutdown()
    server.server_close()


def _client(gateway, **kwargs):
    host, port = gateway.address
    kwargs.setdefault("retry", RETRY)
    return GatewayClient(host=host, port=port, **kwargs)


def test_authenticated_round_trip_serves_suggestions(auth_gateway):
    """With matching secrets the full tenant lifecycle works: attach,
    suggest, observe — proving auth sits UNDER the protocol, not beside
    it."""
    client = _client(auth_gateway, secret=SECRET)
    space = build_space(PRIORS)
    algo = RemoteAlgorithm(
        space, PRIORS, {"random": {"seed": 0}}, client, "tenant-a", seed=0
    )
    params = algo.suggest(2)
    assert params and len(params) == 2
    algo.observe(params, [{"objective": 0.5}, {"objective": 0.7}])
    stats = client.stats()
    assert stats["per_tenant"]["tenant-a"]["n_observed"] == 2
    client.close()


def test_wrong_secret_is_fatal_and_hangs_up(auth_gateway):
    client = _client(auth_gateway, secret="not-the-secret")
    with pytest.raises(AuthenticationError):
        client.stats()
    client.close()


def test_missing_secret_refused_but_ping_stays_open(auth_gateway):
    anon = _client(auth_gateway)
    # Health probes reveal nothing and stay open (netdb contract).
    assert anon.ping()
    with pytest.raises(AuthenticationError):
        anon.stats()
    anon.close()


def test_downgrade_to_open_gateway_refused(open_gateway):
    """A secret-configured client must never silently talk to a no-auth
    listener (DNS/IP hijack, typoed port): no downgrade, fatal refusal."""
    client = _client(open_gateway, secret=SECRET)
    with pytest.raises(AuthenticationError) as excinfo:
        client.stats()
    assert "does not require authentication" in str(excinfo.value)
    client.close()


def test_auth_error_is_fatal_to_the_retry_policy(auth_gateway):
    """The policy must not burn its backoff budget re-sending doomed
    credentials: exactly one handshake per request attempt cycle, surfaced
    immediately."""
    from orion_tpu_torch.storage.retry import is_transient

    client = _client(auth_gateway, secret="wrong")
    with pytest.raises(AuthenticationError) as excinfo:
        client.request("stats")
    assert not is_transient(excinfo.value)
    client.close()


def test_reconnect_redoes_the_handshake(auth_gateway):
    """A restarted/dropped connection re-authenticates transparently —
    the handshake rides _connect, not the constructor."""
    client = _client(auth_gateway, secret=SECRET)
    assert client.ping()
    # Force a dead socket; the next op reconnects + re-handshakes.
    with client._lock:
        client._sock.close()
    assert client.request("stats")["tenants"] == 0
    client.close()
