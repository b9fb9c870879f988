"""Entry points of the port for a harness (counterpart of ``__graft_entry__.py``).

``entry()`` returns the flagship step — the batched RSA-2048 e=65537
signature verify on kernel K1, over the reference's 8 flat operands
(``sig_h, em_h`` and the six per-row key tensors) — with example
operands of the reference's shapes and dtypes.

``dryrun_multichip(n)`` runs the server-side verification step split
over ``n`` shards the way a replica splits it: the signature batch is
cut into contiguous row shards, each verified on its own device and
stream, and the per-shard vote counts are summed on the first device
(the reference sums them with ``psum`` inside ``shard_map``; the port
has no collective).  Then the sign modexp runs through the split of
``ops/rns.py::power_mod_rns``.  Shards wrap over the cards there are
(``n`` shards on one card run on separate streams of it), or all run on
the ``cpu`` when the caller asks for it.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.ops import cuda_rns, limb, rns

__all__ = ["dryrun_multichip", "entry", "flat_verify"]


def _example_operands(batch: int, bits: int = 2048):
    """Real verify operands as numpy float32 (host-built; a fresh random
    key each call — only shapes and dtypes are stable across runs)."""
    from bftkv_tpu_torch.crypto import rsa

    ctx = rns.context()
    key = rsa.generate(bits)
    sig_d, em_d = [], []
    for i in range(batch):
        msg = b"graft-entry-%d" % i
        s = int.from_bytes(rsa.sign(msg, key), "big")
        em = rsa.emsa_pkcs1v15_sha256(msg, key.size_bytes)
        sig_d.append(limb.int_to_limbs(s, rns.DIGITS))
        em_d.append(limb.int_to_limbs(em, rns.DIGITS))
    sig_h = rns.digits_to_halves(np.stack(sig_d))
    em_h = rns.digits_to_halves(np.stack(em_d))
    key_rows = rns.stack_key_rows([ctx.key_rows(key.n)] * batch)
    return (sig_h, em_h) + key_rows


def _halves(a, name: str, dev: torch.device) -> torch.Tensor:
    h = rns._exact_int(a, name)
    if (h > 255).any():
        raise ValueError(f"{name}: digit halves must be below 256")
    return torch.as_tensor(h.astype(np.uint8), device=dev)


def flat_verify(sig_h, em_h, n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r, *,
                device=None) -> torch.Tensor:
    """(T,) bool verdicts of one K1 launch over flat operands: (T, 256)
    digit halves of s and em, and each row's own key rows (the
    :func:`rns.stack_key_rows` tuple), as exact integers in any numeric
    dtype.  On ``cpu`` the plain version runs."""
    dev = devmod.resolve(device)
    sig = _halves(sig_h, "sig_h", dev)
    em = _halves(em_h, "em_h", dev)
    ukey = rns.key_rows_from_numpy((n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r), dev)
    idx = torch.arange(sig.shape[0], dtype=torch.int32, device=dev)
    return cuda_rns.verify_cuda(sig, em, idx, ukey, rns.consts(rns.DIGITS, 2048, dev))


def entry(device=None):
    """(fn, example_args): the batched RNS verify step on ``device``
    (``cuda:0`` unless the caller asks for ``"cpu"``) and 8 example rows."""
    return functools.partial(flat_verify, device=devmod.resolve(device)), _example_operands(batch=8)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def dryrun_multichip(n_devices: int, device=None, *, seed: int = 0) -> dict:
    """The split verify with its summed vote count, then the split sign
    modexp, over ``n_devices`` shards; raises on a wrong verdict, vote
    count or modexp.  Returns what ran: the shard devices, the batch, the
    votes and the pow shard count."""
    if n_devices < 1:
        raise ValueError("n_devices must be at least 1")
    base = devmod.resolve(device)
    if base.type == "cuda":
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", (base.index + i) % count) for i in range(n_devices)]
    else:
        devs = [base] * n_devices

    per_dev = 2
    batch = per_dev * n_devices
    args = list(_example_operands(batch, bits=1024))
    # Corrupt the last signature so the tally is non-trivial.
    args[0] = args[0].copy()
    args[0][-1, 0] = (args[0][-1, 0] + 1) % 256
    oks, counts = [], []
    for lane, dev in enumerate(devs):
        rows = slice(lane * per_dev, (lane + 1) * per_dev)
        with rns.shard_scope(dev, lane):
            ok = flat_verify(*(a[rows] for a in args), device=dev)
            oks.append(ok)
            counts.append(ok.to(torch.int32).sum())
            _sync(dev)  # the vote sum below reads it from another stream
    votes = int(torch.stack([c.to(devs[0]) for c in counts]).sum())
    ok = np.concatenate([o.cpu().numpy() for o in oks])
    if not (ok[:-1].all() and not ok[-1]):
        raise RuntimeError(f"split verify verdicts {ok.tolist()}")
    if votes != batch - 1:
        raise RuntimeError(f"votes {votes} != {batch - 1}")

    # The sign path through the split: power_mod_rns pads to 64 rows and
    # splits when 64 divides by the shard count, as the reference does.
    rng = random.Random(seed)
    ctx = rns.context(32, 512)
    mods, bases, exps = [], [], []
    while len(mods) < n_devices:
        m = rng.getrandbits(500) | 1
        if ctx.key_rows(m) is not None:
            mods.append(m)
            bases.append(rng.getrandbits(490))
            exps.append(rng.getrandbits(470))
    with rns.shard_over(devs):
        shards = rns.shard_devices(devs[0])
        pow_shards = len(shards) if rns._shardable(64, shards) else 1
        got = rns.power_mod_rns(bases, exps, mods, n_bits=512, device=devs[0])
    if got != [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]:
        raise RuntimeError("split sign modexp differs from host pow")
    print(
        f"dryrun_multichip ok: {n_devices} shards on {[str(d) for d in devs]}, "
        f"batch={batch}, votes={votes}/{batch} (RNS verify, summed vote count; "
        f"sign modexp split over {pow_shards} shards)",
        flush=True,
    )
    return {"devices": [str(d) for d in devs], "batch": batch, "votes": votes,
            "pow_shards": pow_shards}


if __name__ == "__main__":
    dryrun_multichip(2)
