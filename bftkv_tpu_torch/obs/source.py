"""Scrape sources for the fleet collector.

Counterpart of ``bftkv_tpu/obs/source.py``.

A *source* is one fleet member's observability surface.  The collector
only needs four operations, so both deployment shapes fit one duck
type:

- :meth:`info` — identity + shard seat + clique thresholds (the
  daemon's ``/info``, computed from ``quorum/wotqs.py`` state);
- :meth:`metrics` — the flat JSON metrics snapshot (includes the
  fixed-bucket histogram keys);
- :meth:`trace_export` — incremental span drain from a cursor
  (:meth:`bftkv_tpu_torch.trace.Tracer.export`);
- :meth:`probe` — cheap liveness check, the f-budget's input.

:class:`HTTPSource` talks to a real daemon API over localhost/LAN.
:class:`LocalSource` wraps an in-process server (the chaos harness and
the loopback tests): liveness comes from the loopback transport's
registration state — ``crash()`` unregisters, so a crashed replica
fails the probe exactly like a dead daemon fails a scrape.  In-process
clusters share ONE metrics registry and tracer per process, so
process-wide feeds (metrics/trace) are attached to the collector once,
not per LocalSource (see ``FleetCollector(local_metrics=...)``).
"""

from __future__ import annotations

import json
import urllib.request

__all__ = ["HTTPSource", "LocalSource", "seat_document"]


def seat_document(qs, node_id: int) -> dict:
    """The seat half of an ``/info`` document — defaults merged with
    :meth:`bftkv_tpu_torch.quorum.wotqs.WotQS.seat_info` when the quorum
    system supports it.  ONE implementation for every deployment
    shape: the daemon endpoint (cmd/bftkv.py) and the in-process
    :class:`LocalSource` both call this, so the HTTP and chaos planes
    cannot drift apart field by field."""
    out = {
        "shard": None,
        "shard_count": 1,
        "role": None,
        "clique": None,
        "region": None,
        "owned_buckets": 256,
    }
    seat_info = getattr(qs, "seat_info", None)
    if seat_info is not None:
        try:
            out.update(seat_info(node_id))
        except Exception:
            pass  # introspection must never take a surface down
    return out


class HTTPSource:
    """One daemon API endpoint (``host:port`` of ``bftkv --api``).

    ``PROBE_BY_SCRAPE``: the collector treats the metrics fetch itself
    as the liveness probe — a separate ``probe()`` round trip per
    member per scrape would just double the request load for no new
    information."""

    PROBE_BY_SCRAPE = True

    def __init__(self, base: str, name: str = "", timeout: float = 3.0):
        if "://" not in base:
            base = "http://" + base
        self.base = base.rstrip("/")
        self.name = name or base.split("://", 1)[1]
        self.timeout = timeout

    def _get_json(self, path: str):
        with urllib.request.urlopen(
            self.base + path, timeout=self.timeout
        ) as res:
            return json.loads(res.read())

    def info(self) -> dict:
        info = self._get_json("/info")
        if info.get("name"):
            self.name = info["name"]
        return info

    def metrics(self) -> dict:
        return self._get_json("/metrics?format=json")

    def trace_export(self, cursor: int) -> dict:
        return self._get_json(f"/trace?since={cursor}")

    def profile(self, seconds: float = 2.0) -> str:
        """On-demand collapsed-stack profile window from the daemon's
        ``/profile`` endpoint (``cmd.fleet --profile``; the request
        blocks for the window, so the timeout stretches to cover it)."""
        with urllib.request.urlopen(
            self.base + f"/profile?seconds={seconds:g}",
            timeout=self.timeout + seconds + 5.0,
        ) as res:
            return res.read().decode()

    def probe(self) -> bool:
        try:
            self._get_json("/info")
            return True
        except Exception:
            return False

    def __repr__(self) -> str:  # pragma: no cover
        return f"HTTPSource({self.name} @ {self.base})"


class LocalSource:
    """One in-process server (loopback transports).

    ``server_fn`` returns the CURRENT server object for this member —
    a callable, not a reference, because the chaos harness's
    crash-restart replaces the ``Server`` instance on the same storage
    (``ChaosCluster.restart``), and health must follow the member, not
    a dead object."""

    def __init__(self, name: str, server_fn):
        self.name = name
        self.server_fn = server_fn

    def info(self) -> dict:
        srv = self.server_fn()
        # A member that builds its own /info document (the edge
        # Gateway: role=gateway + cache stats) is the authority — a
        # seat document derived from its qs would misfile it as a
        # quorum principal.
        own = getattr(srv, "info", None)
        if callable(own):
            doc = dict(own())
            doc.setdefault("name", self.name)
            return doc
        g = srv.self_node
        out = {
            "name": self.name,
            "id": f"{g.get_self_id():016x}",
            "addr": getattr(g, "address", ""),
        }
        out.update(seat_document(srv.qs, g.get_self_id()))
        return out

    def metrics(self) -> dict:
        # One shared registry per process: per-member counters are not
        # attributable in-process.  The collector reads the process
        # registry once per scrape via its ``local_metrics`` feed.
        return {}

    def trace_export(self, cursor: int) -> dict:
        return {"cursor": cursor, "dropped": 0, "spans": [], "slow": []}

    def probe(self) -> bool:
        try:
            tr = self.server_fn().tr
        except Exception:
            return False
        addr = getattr(tr, "_addr", None)
        if addr is None:
            return False  # tr.stop() ran: the member is dark
        net = getattr(tr, "net", None)
        if net is not None:
            return net.servers.get(addr) is not None
        return True

    def __repr__(self) -> str:  # pragma: no cover
        return f"LocalSource({self.name})"
