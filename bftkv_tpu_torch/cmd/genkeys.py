"""Key/topology generator — the GnuPG-scripts replacement (counterpart of
``bftkv_tpu/cmd/genkeys.py``).

Builds the canonical universe (reference: scripts/setup.sh:17-48 —
server clique, storage-only rw nodes, users with quorum certificates)
and writes one home directory (pubring + secring) per principal, the
layout :func:`bftkv_tpu_torch.topology.load_home` and the daemon consume.

    python -m bftkv_tpu_torch.cmd.genkeys --out keys \
        --servers 4 --rw 4 --users 2 --base-port 6001
"""

from __future__ import annotations

import argparse
import os


def write_homes(uni, out: str) -> dict:
    """One home directory per principal of ``uni`` under ``out`` (the
    layout ``topology.load_home`` reads), a gateway's dial address beside
    its keys; returns ``{name: home}``."""
    from bftkv_tpu_torch import topology

    os.makedirs(out, exist_ok=True)
    homes = {}
    for ident in uni.all:
        home = homes[ident.name] = os.path.join(out, ident.name)
        topology.save_home(
            home, ident, uni.view_of(ident),
            local_trust=uni.local_trust_of(ident),
            regions=uni.regions or None,
        )
        dial = uni.gateway_addrs.get(ident.name, "")
        if dial:
            # Gateway certs carry no address (they must stay out of
            # the quorum planes); the dial address is deployment
            # config, dropped beside the keys for run_gateway and for
            # clients assembling their gateway list.
            with open(os.path.join(home, "address"), "w") as f:
                f.write(dial + "\n")
    return homes


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory for the home dirs")
    ap.add_argument("--servers", type=int, default=4,
                    help="quorum servers per shard")
    ap.add_argument("--rw", type=int, default=4,
                    help="storage-only rw nodes per shard")
    ap.add_argument("--shards", type=int, default=1,
                    help="number of disjoint server cliques: the "
                         "keyspace hash-routes across them "
                         "(--servers/--rw are per-shard counts)")
    ap.add_argument("--users", type=int, default=1)
    ap.add_argument("--unsigned-users", type=int, default=0,
                    help="trailing users without quorum certificates (TOFU)")
    ap.add_argument("--gateways", type=int, default=0,
                    help="edge gateway identities (gw01..): quorum-"
                         "certified front-door principals sharing one "
                         "TOFU uid, each with a dialable address "
                         "(bftkv_tpu_torch.cmd.run_gateway serves one)")
    ap.add_argument("--gw-base-port", type=int, default=6201)
    ap.add_argument("--regions", type=int, default=0,
                    help="label every principal round-robin into N "
                         "regions (r0..rN-1) and write a `regions` "
                         "file into each home dir: deployment-plane "
                         "geography for locality-aware staging, "
                         "per-region latency classes and the fleet "
                         "collector's region rollup; certificates are "
                         "untouched")
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--alg", default="rsa", choices=["rsa", "p256", "mixed"],
                    help="identity-key algorithm: RSA-2048, ECDSA P-256, "
                         "or alternating (BASELINE config 4)")
    ap.add_argument("--base-port", type=int, default=6001)
    ap.add_argument("--rw-base-port", type=int, default=6101)
    ap.add_argument("--server-trust-rw", action="store_true",
                    help="servers trust rw nodes in their own views, so "
                         "daemon client-API reads have a read quorum "
                         "(extension; not in the reference topology)")
    args = ap.parse_args(argv)

    from bftkv_tpu_torch import topology

    uni = topology.build_universe(
        args.servers,
        args.users,
        args.rw,
        scheme="http",
        base_port=args.base_port,
        rw_base_port=args.rw_base_port,
        bits=args.bits,
        unsigned_users=args.unsigned_users,
        server_trust_rw=args.server_trust_rw,
        alg=args.alg,
        n_shards=args.shards,
        n_gateways=args.gateways,
        gw_base_port=args.gw_base_port,
        n_regions=args.regions,
    )
    if args.regions > 1:
        by_region: dict[str, list[str]] = {}
        for ident in uni.all:
            if ident.region:
                by_region.setdefault(ident.region, []).append(ident.name)
        print(
            "regions: "
            + "; ".join(
                f"{r}: {','.join(names)}"
                for r, names in sorted(by_region.items())
            )
        )
    if args.shards > 1:
        groups = ", ".join(
            f"shard {i}: {g[0].name}..{g[-1].name}"
            for i, g in enumerate(uni.shards)
        )
        print(f"{args.shards} quorum cliques ({groups})")
    homes = write_homes(uni, args.out)
    for ident in uni.all:
        home = homes[ident.name]
        dial = uni.gateway_addrs.get(ident.name, "")
        print(
            f"{ident.name}: {home} "
            f"({ident.cert.address or dial or 'client'})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
