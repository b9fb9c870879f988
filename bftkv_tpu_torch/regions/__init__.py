"""Region model: deployment-plane geography for a bftkv fleet (counterpart of ``bftkv_tpu/regions/__init__.py``).

A **region** is a named failure-and-latency domain (``r0``, ``r1``,
``eu-west``) assigned to every identity in a universe.  Region labels
are *deployment* metadata, not wire protocol: the certificate formats
(BCR1/BCR2) and the TOFU-pinned uid are untouched.  Labels travel as

- a ``regions`` file in every saved home directory (one
  ``<name> <region>`` pair per line, the ``localtrust`` pattern),
- an attribute on the in-memory :class:`~bftkv_tpu_torch.topology.Identity`
  objects a universe builds (``identity.region``), and
- the process-global :class:`RegionMap` below, which every
  region-aware component (quorum staging, peer-latency classes,
  gateway leases, fleet rollups) consults through :func:`region_of`.

The map is keyed by node *name* and by transport *link id*
(``link_of(address)``) so both planes — protocol code holding
identities and transport code holding addresses — resolve the same
label.  An **empty map is the loopback/single-region world**: every
lookup returns ``None``, every rank is 0, and region-aware code paths
reduce bit-for-bit to their pre-region behavior.
"""

from __future__ import annotations

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "RegionMap",
    "regionmap",
    "region_of",
    "self_region",
    "install",
    "clear",
]


class RegionMap:
    """Process-global name/link → region mapping plus the optional
    inter-region RTT matrix used for distance ranking.

    Reads are lock-free against an immutable snapshot dict; installs
    swap the whole snapshot under a small lock (install happens at
    boot / test setup, lookups happen on every staged write)."""

    def __init__(self):
        self._lock = named_lock("regions.map")
        self._by_key: dict[str, str] = {}
        self._rtt = None  # Optional[RttMatrix]

    # -- lifecycle --------------------------------------------------------

    def install(self, mapping: dict, rtt=None) -> "RegionMap":
        """Install ``{name_or_addr: region}``.  Addresses are also
        indexed under their link id so transport code can resolve by
        either form.  ``rtt`` (an ``RttMatrix``) enables distance
        ranking between distinct regions."""
        from bftkv_tpu_torch.faults.failpoint import link_of

        by_key: dict[str, str] = {}
        for key, region in (mapping or {}).items():
            if not key or not region:
                continue
            by_key[str(key)] = str(region)
            link = link_of(str(key))
            if link and link != key:
                by_key[link] = str(region)
        with self._lock:
            self._by_key = by_key
            if rtt is not None or not by_key:
                self._rtt = rtt
        return self

    def merge(self, mapping: dict) -> "RegionMap":
        """Add labels without dropping existing ones (idempotent —
        every home directory of one universe carries the same
        ``regions`` file, and each load re-merges it)."""
        from bftkv_tpu_torch.faults.failpoint import link_of

        with self._lock:
            by_key = dict(self._by_key)
            for key, region in (mapping or {}).items():
                if not key or not region:
                    continue
                by_key[str(key)] = str(region)
                link = link_of(str(key))
                if link and link != key:
                    by_key[link] = str(region)
            self._by_key = by_key
        return self

    def set_rtt(self, rtt) -> None:
        with self._lock:
            self._rtt = rtt

    def clear(self) -> None:
        with self._lock:
            self._by_key = {}
            self._rtt = None

    def installed(self) -> bool:
        return bool(self._by_key)

    # -- lookups ----------------------------------------------------------

    def region_of(self, key: str | None) -> str | None:
        """Region label for a node name or transport address (``None``
        when unlabeled or the map is empty — the loopback world)."""
        if not key:
            return None
        by_key = self._by_key
        if not by_key:
            return None
        key = str(key)
        r = by_key.get(key)
        if r is not None:
            return r
        if "://" in key or "/" in key:
            from bftkv_tpu_torch.faults.failpoint import link_of

            return by_key.get(link_of(key))
        return None

    def regions(self) -> list[str]:
        return sorted(set(self._by_key.values()))

    def members(self, region: str) -> list[str]:
        """Node names labeled ``region`` (link-id aliases excluded)."""
        return sorted(
            k
            for k, r in self._by_key.items()
            if r == region and "://" not in k and ":" not in k
        )

    def rtt(self, a: str | None, b: str | None) -> float | None:
        """Inter-region RTT in seconds when a matrix is installed and
        both labels are known; ``None`` otherwise."""
        m = self._rtt
        if m is None or a is None or b is None:
            return None
        try:
            return m.rtt(a, b)
        except (KeyError, ValueError):
            return None

    def rank(self, own: str | None, other: str | None) -> float:
        """Locality rank of ``other`` as seen from ``own`` — the sort
        key region-aware staging inserts between the health flag and
        the cold bit.  0.0 for same-region and for every unknown label
        (so an uninstalled map preserves existing order bit-for-bit);
        cross-region ranks by RTT when a matrix is installed, else a
        flat 1.0."""
        if own is None or other is None or own == other:
            return 0.0
        d = self.rtt(own, other)
        if d is not None:
            return max(d, 1e-9)
        return 1.0


#: Module singleton every region-aware component consults.
regionmap = RegionMap()


def install(mapping: dict, rtt=None) -> RegionMap:
    return regionmap.install(mapping, rtt=rtt)


def clear() -> None:
    regionmap.clear()


def region_of(key: str | None) -> str | None:
    return regionmap.region_of(key)


def self_region(name: str | None = None) -> str | None:
    """This process's own region: the ``BFTKV_REGION`` override wins
    (a gateway box pinned to its serving region), else the label of
    ``name`` in the installed map."""
    r = flags.raw("BFTKV_REGION")
    if r:
        return r
    return regionmap.region_of(name)
