"""Guards of the port: no JAX and no reference import, explicit devices,
and the port's own flag seam."""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bftkv_tpu_torch
from bftkv_tpu_torch import flags

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(bftkv_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "bftkv_tpu")


def _port_files() -> list[Path]:
    files = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def test_port_imports_no_jax_and_no_reference_package():
    offenders = []
    for path in _port_files():
        for mod in _imported_modules(path):
            # Exact top-level name: bftkv_tpu_torch starts with bftkv_tpu.
            if mod.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not offenders, offenders


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import bftkv_tpu_torch, bftkv_tpu_torch.ops.rns, bftkv_tpu_torch.ops.cuda_rns\n"
        "import bftkv_tpu_torch.ops.dispatch, bftkv_tpu_torch.crypto.rsa\n"
        "import bftkv_tpu_torch.ops.bigint, bftkv_tpu_torch.ops.rsa\n"
        "import bftkv_tpu_torch.ops.cuda_mont, bftkv_tpu_torch.ops.modexp\n"
        "import bftkv_tpu_torch.ops.devbuf, bftkv_tpu_torch.trace\n"
        "import bftkv_tpu_torch.faults.failpoint, bftkv_tpu_torch.devtools.lockwatch\n"
        "import bftkv_tpu_torch.errors, bftkv_tpu_torch.crypto.rng, bftkv_tpu_torch.crypto.ec\n"
        "import bftkv_tpu_torch.crypto.ecdsa, bftkv_tpu_torch.ops.ec\n"
        "import bftkv_tpu_torch.ops.ec_rns, bftkv_tpu_torch.ops.cuda_ec\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        "print(sorted(new & {'jax', 'jaxlib', 'bftkv_tpu'}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120, check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _entry_points():
    from bftkv_tpu_torch.crypto import ecdsa, rsa
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import bigint, dispatch, ec, ec_rns, modexp, rns
    from bftkv_tpu_torch.ops import rsa as rsa_ops

    ctx = rns.context(16, 256)
    digits = np.zeros((256, 128), np.uint32)
    g = (P256.gx, P256.gy)
    key = ecdsa.ECPrivateKey(d=1, public=ecdsa.ECPublicKey(x=P256.gx, y=P256.gy))
    # Both batches at their crossover, so they reach the device.
    verify_items = [(b"m", ecdsa.sign(b"m", key), key.public)] * ecdsa.VERIFY_HOST_CROSSOVER
    sign_msgs = [b"m"] * ecdsa.SIGN_HOST_CROSSOVER
    return {
        "ec_scalar_mult_hosts": lambda: ec.scalar_mult_hosts([g], [3], device="cuda"),
        "ec_rns_scalar_mult_hosts": lambda: ec_rns.scalar_mult_hosts([g], [3], device="cuda"),
        "ec_rns_engine": lambda: ec_rns.engine("cuda"),
        "ecdsa_sign_batch": lambda: ecdsa.sign_batch(sign_msgs, key, device="cuda"),
        "ecdsa_verify_batch": lambda: ecdsa.verify_batch(verify_items, device="cuda"),
        "verify_e65537_rns_indexed": lambda: rns.verify_e65537_rns_indexed(
            [0], [0], [0], [rns.context().key_rows((1 << 2047) + 1)], device="cuda",
        ),
        "power_mod_rns": lambda: rns.power_mod_rns([2], [3], [5], device="cuda"),
        "consts_from_numpy": lambda: rns.consts_from_numpy(
            rns.context_arrays(ctx), "cuda"
        ),
        "key_rows_from_numpy": lambda: rns.key_rows_from_numpy(
            tuple(np.zeros((1, 1), np.float32) for _ in range(6)), "cuda"
        ),
        "VerifierDomain": lambda: rsa.VerifierDomain(device="cuda"),
        "SignerDomain": lambda: rsa.SignerDomain(device="cuda"),
        "VerifyDispatcher": lambda: dispatch.VerifyDispatcher(device="cuda"),
        "SignDispatcher": lambda: dispatch.SignDispatcher(device="cuda"),
        "ModexpDispatcher": lambda: dispatch.ModexpDispatcher(device="cuda"),
        "calibration": lambda: dispatch.calibration(device="cuda"),
        "limbs_from_numpy": lambda: bigint.limbs_from_numpy(digits, "cuda"),
        "verify_batch_e65537": lambda: rsa_ops.verify_batch_e65537(
            *(digits,) * 5, device="cuda"
        ),
        "power_batch": lambda: rsa_ops.power_batch(*(digits,) * 6, device="cuda"),
        "BatchModExp": lambda: modexp.BatchModExp(device="cuda"),
        "VerifierDomain_limb": lambda: rsa.VerifierDomain(device="cuda", backend="limb"),
        "VerifierDomain_pallas": lambda: rsa.VerifierDomain(device="cuda", backend="pallas"),
        "SignerDomain_limb": lambda: rsa.SignerDomain(device="cuda", backend="limb"),
    }


ENTRY_POINTS = [
    "BatchModExp", "ModexpDispatcher", "SignDispatcher", "SignerDomain", "SignerDomain_limb",
    "VerifierDomain", "VerifierDomain_limb", "VerifierDomain_pallas",
    "VerifyDispatcher", "calibration", "consts_from_numpy", "ec_rns_engine",
    "ec_rns_scalar_mult_hosts", "ec_scalar_mult_hosts", "ecdsa_sign_batch",
    "ecdsa_verify_batch", "key_rows_from_numpy",
    "limbs_from_numpy", "power_batch", "power_mod_rns", "verify_batch_e65537",
    "verify_e65537_rns_indexed",
]


def test_entry_point_list_is_complete():
    assert sorted(_entry_points()) == ENTRY_POINTS


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_cuda_request_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_default_device_is_cuda():
    from bftkv_tpu_torch import device

    assert device.DEFAULT == "cuda:0"
    assert device.resolve("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device.resolve(None)
    with pytest.raises(RuntimeError):
        device.resolve("meta")


def test_flag_seam():
    with pytest.raises(KeyError):
        flags.raw("BFTKV_NOT_DECLARED")
    assert set(flags.declared()) == {
        "BFTKV_HOST_VERIFY_THRESHOLD",
        "BFTKV_HOST_SIGN_THRESHOLD",
        "BFTKV_DISPATCH_CROSSOVER",
        "BFTKV_VERIFY_BACKEND",
        "BFTKV_SIGN_BACKEND",
        "BFTKV_TPU_MIN_MODEXP_BATCH",
        "BFTKV_DISPATCH_CALIBRATE",
        "BFTKV_DISPATCH_PIPELINE",
        "BFTKV_DISPATCH_ASYNC",
        "BFTKV_DISPATCH_DEVBUF",
        "BFTKV_DISPATCH_DEVBUF_RING",
        "BFTKV_EC_BACKEND",
        "BFTKV_EC_SIGN_THRESHOLD",
        "BFTKV_EC_VERIFY_THRESHOLD",
        "BFTKV_OS_RNG",
        "BFTKV_TRACE",
        "BFTKV_SLOW_TRACE_SECONDS",
        "BFTKV_LOCKWATCH",
    }
    # Every declared flag is read somewhere in the port, and no BFTKV_*
    # name is read from the environment outside flags.py.
    blob = "\n".join(p.read_text() for p in _port_files() if p.name != "flags.py")
    assert [n for n in flags.declared() if n not in blob] == []
    pat = re.compile(r"(?:environ(?:\.get)?\s*[\(\[]|getenv\s*\()\s*f?['\"]BFTKV_")
    assert not [p for p in _port_files() if p.name != "flags.py" and pat.search(p.read_text())]
