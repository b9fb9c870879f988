"""The hand-written kernels on the card (skips where there is no CUDA).

Each kernel against its plain PyTorch version on the same device tensors
(exact: every value is an integer), and the entry points and domains on
``cuda`` against host ``pow``/``sign``, with the launches counted.  This
file imports neither ``jax`` nor the reference package, so it runs on a
GPU machine without JAX:

    BFTKV_TPU_LANE=1 python3 -m pytest tests/test_torch_cuda.py -m cuda -q
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.ops import cuda_rns, limb, rns
from test_torch_utils import moduli as _moduli

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_k1_matches_plain_on_card(dev):
    ctx = rns.context()
    ns = _moduli(ctx, 2048, 4, seed=21)
    rng = random.Random(22)
    n_rows = 300  # not a multiple of the kernel's rows per block
    idx = np.array([rng.randrange(4) for _ in range(n_rows)], dtype=np.int32)
    sigs = [rng.randrange(ns[i]) for i in idx]
    ems = [pow(s, 65537, ns[i]) if j % 2 else rng.randrange(ns[i])
           for j, (s, i) in enumerate(zip(sigs, idx))]
    sh = rns.digits_to_halves_u8(np.stack([limb.int_to_limbs(s, 128) for s in sigs]))
    eh = rns.digits_to_halves_u8(np.stack([limb.int_to_limbs(e, 128) for e in ems]))
    ukey = rns.key_rows_from_numpy(
        rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev
    )
    cn = rns.consts(128, 2048, dev)
    args = (torch.from_numpy(sh).to(dev), torch.from_numpy(eh).to(dev),
            torch.from_numpy(idx).to(dev))
    got = cuda_rns.verify_cuda(*args, ukey, cn).cpu().numpy()
    plain = rns._verify_kernel(
        cn, args[0], args[1], rns.gather_key(ukey, args[2])
    ).cpu().numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, [j % 2 == 1 for j in range(n_rows)])


def test_k2_matches_plain_on_card(dev):
    ctx = rns.context(64, 1024)
    ns = _moduli(ctx, 1024, 4, seed=23)
    rng = np.random.default_rng(24)
    n_rows = 66  # not a multiple of the kernel's rows per block
    idx = torch.as_tensor(rng.integers(0, 4, n_rows).astype(np.int32), device=dev)
    bh = torch.as_tensor(rng.integers(0, 256, (n_rows, 128)).astype(np.uint8), device=dev)
    nib = torch.as_tensor(rng.integers(0, 16, (256, n_rows)).astype(np.uint8), device=dev)
    ukey = rns.key_rows_from_numpy(
        rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev
    )
    cn = rns.consts(64, 1024, dev)
    got = cuda_rns.pow_cuda(bh, nib, idx, ukey, cn)
    plain = rns._pow_kernel(cn, bh, nib, rns.gather_key(ukey, idx))
    assert torch.equal(got.long(), plain)


def test_entry_points_on_card_match_host_pow(dev):
    ctx = rns.context(64, 1024)
    mods = _moduli(ctx, 1024, 3, seed=25)
    rng = random.Random(26)
    rows = [mods[i % 3] for i in range(70)]
    bases = [rng.getrandbits(2048) for _ in rows]
    exps = [rng.getrandbits(1024) for _ in rows]
    cuda_rns.reset_launches()
    out = rns.power_mod_rns(bases, exps, rows, n_bits=1024, defer=True, device=dev)
    assert out.wait() == [pow(b, e, m) for b, e, m in zip(bases, exps, rows)]
    assert cuda_rns.LAUNCHES == {"verify": 0, "pow": 1}


def test_domains_on_card_match_host(dev):
    keys = [rsa.generate(2048, seed=s) for s in (31, 32)]
    items = [(b"m%d" % i, keys[i % 2]) for i in range(6)]
    cuda_rns.reset_launches()
    sigs = rsa.SignerDomain(device=dev, host_threshold=0).sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    assert cuda_rns.LAUNCHES == {"verify": 1, "pow": 1}  # sign + fault check
    vitems = [(m, s if i % 3 else s[:-1] + bytes([s[-1] ^ 1]), k.public)
              for i, ((m, k), s) in enumerate(zip(items, sigs))]
    got = rsa.VerifierDomain(device=dev, host_threshold=0).verify_batch(vitems)
    np.testing.assert_array_equal(got, [i % 3 != 0 for i in range(6)])
    assert cuda_rns.LAUNCHES == {"verify": 2, "pow": 1}
