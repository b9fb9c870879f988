"""Protocol layer: the replicated-KV state machines (counterpart of
``bftkv_tpu/protocol/__init__.py``).

Capability parity with the reference's ``protocol`` package:
- :class:`Protocol` — shared state (self node, quorum system, transport,
  crypto, threshold) + membership gossip (reference:
  protocol/protocol.go:13-60);
- :class:`bftkv_tpu_torch.protocol.client.Client` — three-phase signed write,
  quorum read with read-repair and revoke-on-read, TPA rounds,
  threshold-signing rounds (reference: protocol/client.go:52-546);
- :class:`bftkv_tpu_torch.protocol.server.Server` — the 13 command handlers
  behind decrypt→dispatch→encrypt (reference: protocol/server.go:33-620).

Device seam: the protocol layer is control flow — pure Python, no
tensors.  All hot crypto (signature verify/sign, modexp, tallies) is
delegated downward to ``bftkv_tpu_torch.crypto`` / ``bftkv_tpu_torch.ops`` where it
runs as batched device kernels; the server additionally funnels verify
work through the cross-request batching dispatcher
(``bftkv_tpu_torch.ops.dispatch``) so concurrent handlers share kernel
launches.  A :class:`Protocol` is built for one ``device`` (``None``:
``cuda:0``, which raises without CUDA; ``"cpu"``: the plain versions),
the one its crypt's collective verifier runs on.
"""

from __future__ import annotations

from collections import Counter

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto.threshold import ThresholdInstance

__all__ = ["Protocol", "majority_error", "MAX_UINT64", "Ref"]

MAX_UINT64 = 2**64 - 1


class Ref:
    """Minimal node stand-in for revoking an id we have no cert for."""

    __slots__ = ("id",)

    def __init__(self, nid: int):
        self.id = nid


def majority_error(errs: list, fallback):
    """The most common error in a fan-out, or ``fallback`` when none
    (reference: protocol/client.go:28-50)."""
    if not errs:
        return fallback
    counts = Counter(str(e) for e in errs)
    winner = counts.most_common(1)[0][0]
    for e in errs:
        if str(e) == winner:
            return e
    return fallback


class Protocol:
    """Shared protocol state (reference: protocol/protocol.go:13-19).

    ``self_node`` is the trust :class:`bftkv_tpu_torch.graph.Graph` doubling
    as the node identity, exactly as the reference's ``Graph``
    implements ``SelfNode``.
    """

    def __init__(self, self_node, qs, tr, crypt, *, device=None):
        self.device = devmod.resolve(device)
        # The crypt's batched verify must run where this node does: a
        # crypt built for another device is refused, not silently mixed.
        cdev = getattr(crypt.collective.verifier, "device", None)
        if cdev is not None and cdev != self.device:
            raise ValueError(
                f"crypt verifies on {str(cdev)!r}, node built for {str(self.device)!r}"
            )
        self.self_node = self_node
        self.qs = qs
        self.tr = tr
        self.crypt = crypt
        self.threshold = ThresholdInstance(crypt, device=self.device)

    def joining(self) -> None:
        """Iterative gossip crawl: multicast Join to every not-yet-asked
        peer, fold returned certificates into the graph + keyring,
        repeat until no new peers appear (reference:
        protocol/protocol.go:21-52)."""
        asked: set[int] = set()
        pkt = self.self_node.serialize_self()
        while True:
            peers = [
                n for n in self.self_node.get_peers() if n.id not in asked
            ]
            if not peers:
                break
            asked.update(n.id for n in peers)

            def cb(res: tp.MulticastResponse) -> bool:
                # Errors are ignored: the peer may simply not know our
                # certificate yet (reference: protocol.go:39-41).
                if res.data:
                    try:
                        nodes = certmod.parse(res.data)
                    except Exception:
                        return False
                    added = self.self_node.add_peers(nodes)
                    try:
                        self.crypt.keyring.register(added)
                    except Exception:
                        self.self_node.remove_peers(added)
                return False  # go through all nodes

            self.tr.multicast(tp.JOIN, peers, pkt, cb)

    def leaving(self) -> None:
        """Broadcast our departure (reference: protocol/protocol.go:54-60)."""
        pkt = self.self_node.serialize_self()
        self.tr.multicast(tp.LEAVE, self.self_node.get_peers(), pkt, None)
