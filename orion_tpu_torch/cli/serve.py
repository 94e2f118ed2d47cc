"""`orion-tpu-torch serve`: run the multi-tenant suggest gateway (port of
``orion_tpu/cli/serve.py``).

One long-lived process owns the card and the algorithm instances of N
experiments (``orion_tpu_torch.serve``); workers point at it with
``serve: {address: host:port}`` in their config (or ``ORION_SERVE_ADDRESS``)
and concurrent same-signature suggest traffic is coalesced into one
dispatch.  The port adds ``--device``: the tenants run on ``cuda`` unless
``--device cpu`` is given, and the command exits 1 where no card is present
rather than serving from the CPU.  See ``docs/serving.md`` for the protocol,
coalescing semantics, and tenancy knobs.
"""


def add_subparser(subparsers):
    parser = subparsers.add_parser(
        "serve", help="run the multi-tenant suggest gateway"
    )
    parser.add_argument("--host", default="127.0.0.1", help="bind address")
    parser.add_argument(
        "--port", type=int, default=8777, help="bind port (default 8777)"
    )
    parser.add_argument(
        "--window-ms",
        type=float,
        default=4.0,
        metavar="ms",
        help="coalescing window: how long the dispatcher waits after the "
        "first queued suggest for more same-signature traffic (default 4ms)",
    )
    parser.add_argument(
        "--max-width",
        type=int,
        default=8,
        metavar="N",
        help="most tenants in one coalesced dispatch",
    )
    parser.add_argument(
        "--max-tenants",
        type=int,
        default=256,
        metavar="N",
        help="hosted-experiment cap; attaches beyond it evict the "
        "least-recently-active idle tenant",
    )
    parser.add_argument(
        "--max-inflight",
        type=int,
        default=4,
        metavar="N",
        help="per-tenant concurrent-suggest quota (excess gets RETRY-AFTER)",
    )
    parser.add_argument(
        "--max-q",
        type=int,
        default=4096,
        metavar="N",
        help="per-tenant per-ask suggestion cap",
    )
    parser.add_argument(
        "--pending-limit",
        type=int,
        default=256,
        metavar="N",
        help="bounded admission queue; a full queue answers RETRY-AFTER",
    )
    parser.add_argument(
        "--persist",
        default=None,
        metavar="path",
        help="snapshot tenant state (history, trust region, RNG stream) so "
        "a restarted gateway resumes its tenants without client replay.  "
        "In fleet mode this is a DIRECTORY of per-tenant snapshots "
        "(shared storage lets a survivor restore a killed member's "
        "tenants bit-identically)",
    )
    parser.add_argument(
        "--fleet",
        default=None,
        metavar="addr1,addr2,...",
        help="run as one member of a gateway fleet: the full comma-"
        "separated member list (this gateway included).  Tenants are "
        "placed on members by consistent hash; membership changes "
        "(fleet_set) migrate tenants through a fenced zero-loss handoff "
        "(docs/serving.md \"Fleet deployment\")",
    )
    parser.add_argument(
        "--advertise",
        default=None,
        metavar="host:port",
        help="this member's own address exactly as it appears in --fleet "
        "(defaults to host:port when that spelling is in the list)",
    )
    parser.add_argument(
        "--handoff-ttl",
        type=float,
        default=30.0,
        metavar="s",
        help="seconds a fenced tenant may stay in handoff before the "
        "DX008 doctor rule calls it stuck (default 30)",
    )
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        metavar="PORT",
        help="serve /metrics (Prometheus text exposition of the gateway's "
        "telemetry registry) and /healthz (queue depth, tenant count) on "
        "this port",
    )
    parser.add_argument(
        "--secret-file",
        default=None,
        metavar="path",
        help="file holding the shared secret clients must prove knowledge "
        "of (the netdb HMAC handshake on the gateway wire).  Clients set "
        "ORION_SERVE_SECRET_FILE or serve.secret_file.",
    )
    parser.add_argument(
        "--no-auth",
        action="store_true",
        help="explicitly run WITHOUT authentication (localhost development "
        "only — any peer that can reach the port can drive every tenant's "
        "suggestion stream)",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="device of the tenants' algorithms (default cuda; the command "
        "fails where no CUDA device is present unless cpu is given)",
    )
    parser.set_defaults(func=main)
    return parser


def main(args):  # pragma: no cover - thin CLI shim over serve()
    import sys

    from orion_tpu_torch.device import resolve_device
    from orion_tpu_torch.serve.gateway import serve

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    secret = None
    if args.secret_file:
        from orion_tpu_torch.storage.base import resolve_wire_secret

        secret = resolve_wire_secret(
            {"secret_file": args.secret_file},
            env_prefix="ORION_SERVE",
            what="serve gateway",
        )
    elif not args.no_auth:
        # Secure by default, same contract as `db serve`: an open gateway
        # hands every tenant's suggestion stream to anyone on the network.
        print(
            "ERROR: refusing to serve without authentication.  Pass "
            "--secret-file <path> (recommended), or --no-auth for "
            "localhost development.",
            file=sys.stderr,
        )
        return 1
    if args.metrics_port is not None:
        # Asking for a scrape endpoint IS asking for metrics: a gateway
        # started with --metrics-port but without ORION_TPU_TELEMETRY
        # would serve an empty exposition forever.
        from orion_tpu_torch.telemetry import TELEMETRY

        TELEMETRY.enable()
    fleet = None
    advertise = None
    if args.fleet:
        fleet = [s.strip() for s in args.fleet.split(",") if s.strip()]
        advertise = args.advertise or f"{args.host}:{args.port}"
    serve(
        host=args.host,
        port=args.port,
        window=args.window_ms / 1e3,
        max_width=args.max_width,
        max_tenants=args.max_tenants,
        max_inflight=args.max_inflight,
        max_q=args.max_q,
        pending_limit=args.pending_limit,
        persist=args.persist,
        metrics_port=args.metrics_port,
        secret=secret,
        fleet=fleet,
        advertise=advertise,
        handoff_ttl=args.handoff_ttl,
        device=device,
    )
    return 0
