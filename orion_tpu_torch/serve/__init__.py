"""Multi-tenant suggest gateway: one card, many live experiments (port of
``orion_tpu/serve``).

A long-lived :class:`GatewayServer` owns the card and the algorithm
instances of N experiments; workers reach it through
:class:`GatewayClient` / :class:`RemoteAlgorithm` (the ``BaseAlgorithm``
adapter the producer drives through a ``serve: {address: ...}`` config
section) and never touch the card themselves.  Concurrent suggest traffic
from tenants sharing a plan signature is coalesced into one dispatch of
their standalone rounds (``orion_tpu_torch.serve.coalesce``), bit-identical
per tenant to a round served alone.  See ``docs/serving.md`` for the protocol.
"""

from orion_tpu_torch.serve.client import (  # noqa: F401
    GatewayClient,
    RemoteAlgorithm,
    connect_remote_algorithm,
)
from orion_tpu_torch.serve.fleet import (  # noqa: F401
    FleetRouter,
    FleetState,
    TenantStore,
    parse_serve_addresses,
    ring_key,
)
from orion_tpu_torch.serve.gateway import GatewayServer  # noqa: F401
from orion_tpu_torch.serve.protocol import (  # noqa: F401
    GatewayError,
    RetryAfterError,
    UnknownTenantError,
    WrongGatewayError,
)
