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
        "import bftkv_tpu_torch.ops.tally, bftkv_tpu_torch.entry, bftkv_tpu_torch.admission\n"
        "import bftkv_tpu_torch.packet, bftkv_tpu_torch.crypto.aead, bftkv_tpu_torch.crypto.cert\n"
        "import bftkv_tpu_torch.cmd.verify_sidecar, bftkv_tpu_torch.crypto.remote_verify\n"
        "import bftkv_tpu_torch.crypto, bftkv_tpu_torch.crypto.vcache, bftkv_tpu_torch.crypto.sss\n"
        "import bftkv_tpu_torch.crypto.dataenc, bftkv_tpu_torch.crypto.keyring\n"
        "import bftkv_tpu_torch.crypto.signature, bftkv_tpu_torch.crypto.message\n"
        "import bftkv_tpu_torch.crypto.auth, bftkv_tpu_torch.crypto.threshold\n"
        "import bftkv_tpu_torch.crypto.threshold.dsa_core, bftkv_tpu_torch.crypto.threshold.rsa\n"
        "import bftkv_tpu_torch.crypto.threshold.dsa, bftkv_tpu_torch.crypto.threshold.ecdsa\n"
        "import bftkv_tpu_torch.native, bftkv_tpu_torch.graph, bftkv_tpu_torch.quorum.wotqs\n"
        "import bftkv_tpu_torch.regions, bftkv_tpu_torch.regions.topology\n"
        "import bftkv_tpu_torch.storage, bftkv_tpu_torch.storage.memkv\n"
        "import bftkv_tpu_torch.storage.segment, bftkv_tpu_torch.storage.plain\n"
        "import bftkv_tpu_torch.storage.logkv, bftkv_tpu_torch.storage.compact\n"
        "import bftkv_tpu_torch.storage.native, bftkv_tpu_torch.topology\n"
        "import bftkv_tpu_torch.transport, bftkv_tpu_torch.transport.latency\n"
        "import bftkv_tpu_torch.transport.loopback, bftkv_tpu_torch.transport.http\n"
        "import bftkv_tpu_torch.crypto.presession, bftkv_tpu_torch.protocol\n"
        "import bftkv_tpu_torch.protocol.server, bftkv_tpu_torch.protocol.client\n"
        "import bftkv_tpu_torch.sync, bftkv_tpu_torch.sync.digest, bftkv_tpu_torch.sync.daemon\n"
        "import bftkv_tpu_torch.api\n"
        "import bftkv_tpu_torch.obs, bftkv_tpu_torch.obs.source, bftkv_tpu_torch.obs.profiler\n"
        "import bftkv_tpu_torch.transport.visual, bftkv_tpu_torch.faults\n"
        "import bftkv_tpu_torch.cmd.genkeys, bftkv_tpu_torch.cmd.bftkv, bftkv_tpu_torch.cmd.run_cluster\n"
        "import bftkv_tpu_torch.cmd.bftrw, bftkv_tpu_torch.cmd.run_gateway\n"
        "import bftkv_tpu_torch.workload, bftkv_tpu_torch.workload.spec\n"
        "import bftkv_tpu_torch.workload.universe, bftkv_tpu_torch.workload.driver\n"
        "import bftkv_tpu_torch.gateway, bftkv_tpu_torch.gateway.cache, bftkv_tpu_torch.gateway.coalesce\n"
        "import bftkv_tpu_torch.gateway.client, bftkv_tpu_torch.gateway.gateway\n"
        "import bftkv_tpu_torch.obs.stitch, bftkv_tpu_torch.obs.critpath, bftkv_tpu_torch.obs.capacity\n"
        "import bftkv_tpu_torch.obs.collector, bftkv_tpu_torch.obs.recorder, bftkv_tpu_torch.obs.http\n"
        "import bftkv_tpu_torch.cmd.fleet, bftkv_tpu_torch.faults.byzantine\n"
        "import bftkv_tpu_torch.faults.checker, bftkv_tpu_torch.faults.harness\n"
        "import bftkv_tpu_torch.faults.nemesis, bftkv_tpu_torch.autopilot\n"
        "import bftkv_tpu_torch.autopilot.plan, bftkv_tpu_torch.autopilot.daemon\n"
        "import bftkv_tpu_torch.autopilot.__main__, bftkv_tpu_torch.cmd.import_gpg\n"
        "from bftkv_tpu_torch.ops import _build\n"
        "new = set(sys.modules) - before\n"
        "tops = {m.split('.')[0] for m in new}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'bftkv_tpu', 'triton'}),\n"
        "      'torch.utils.cpp_extension' in new, _build._lib is None)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120, check=True,
    )
    # No JAX, no reference, no Triton, no kernel build at import.
    assert out.stdout.strip() == "[] False True", out.stdout + out.stderr


def test_importing_the_crypto_layer_builds_only_under_build(tmp_path):
    """The native codec and modexp build from ``native/``'s sources into the
    port's ``_build/native/``: nothing is written under ``native/`` (on a
    copy of the package and the sources, so no other process's build is
    seen)."""
    import shutil

    shutil.copytree(PKG, tmp_path / "bftkv_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so", ".*.lock", "__pycache__"))
    before = sorted(p.name for p in (tmp_path / "native").iterdir())
    code = (
        "import bftkv_tpu_torch.packet as p, bftkv_tpu_torch.crypto.rsa as r\n"
        "import bftkv_tpu_torch.crypto, bftkv_tpu_torch.crypto.auth\n"
        "import bftkv_tpu_torch.crypto.threshold.rsa, bftkv_tpu_torch.crypto.message\n"
        "print(p._C is not None, r._MM is not None)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)), cwd=str(tmp_path), timeout=300, check=True,
    )
    assert out.stdout.split() == ["True", "True"], out.stdout + out.stderr
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == before
    built = sorted(p.name.split(".")[0] for p in (tmp_path / "bftkv_tpu_torch" / "_build" / "native").glob("*.so"))
    assert built == ["_montmodexp", "_packetcodec"]


def test_native_storage_builds_kvstore_only_under_build(tmp_path):
    """``NativeStorage`` builds ``native/kvstore.cpp`` into the port's
    ``_build/native/libbftkvstore.so`` (never under ``native/``), and a
    failed build raises instead of falling back to another engine."""
    import shutil

    shutil.copytree(PKG, tmp_path / "bftkv_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so", ".*.lock", "__pycache__"))
    before = sorted(p.name for p in (tmp_path / "native").iterdir())
    code = (
        "import os, sys\n"
        "from bftkv_tpu_torch.storage.native import NativeStorage\n"
        "s = NativeStorage(os.path.join(sys.argv[1], 'kv'))\n"
        "s.write(b'x', 7, b'v'); print(s.read(b'x').decode(), s.versions(b'x'))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True,
        env=env, cwd=str(tmp_path), timeout=300, check=True,
    )
    assert out.stdout.split() == ["v", "[7]"], out.stdout + out.stderr
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == before
    built = tmp_path / "bftkv_tpu_torch" / "_build" / "native"
    assert [p.name for p in built.glob("lib*.so")] == ["libbftkvstore.so"]
    # A compiler that fails: the build raises, nothing loads in its place.
    (built / "libbftkvstore.so").unlink()
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True,
        env=dict(env, CXX="false"), cwd=str(tmp_path), timeout=300,
    )
    assert out.returncode != 0 and "CalledProcessError" in out.stderr, out.stdout + out.stderr
    assert not (built / "libbftkvstore.so").exists()


def _entry_points():
    from bftkv_tpu_torch.crypto import auth, new_crypto, signature
    from bftkv_tpu_torch.crypto import ecdsa, rsa
    from bftkv_tpu_torch.crypto.threshold import ThresholdInstance
    from bftkv_tpu_torch.crypto.threshold import dsa as tdsa
    from bftkv_tpu_torch.crypto.threshold import ecdsa as tecdsa
    from bftkv_tpu_torch.crypto.threshold import rsa as trsa
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch import api, entry, topology
    from bftkv_tpu_torch.protocol.client import Client
    from bftkv_tpu_torch.protocol.server import Server
    from bftkv_tpu_torch.storage.memkv import MemStorage
    from bftkv_tpu_torch.cmd import verify_sidecar
    from bftkv_tpu_torch.ops import bigint, dispatch, ec, ec_rns, modexp, rns, tally
    from bftkv_tpu_torch.ops import rsa as rsa_ops

    ctx = rns.context(16, 256)
    digits = np.zeros((256, 128), np.uint32)
    g = (P256.gx, P256.gy)
    key = ecdsa.ECPrivateKey(d=1, public=ecdsa.ECPublicKey(x=P256.gx, y=P256.gy))
    # Both batches at their crossover, so they reach the device.
    verify_items = [(b"m", ecdsa.sign(b"m", key), key.public)] * ecdsa.VERIFY_HOST_CROSSOVER
    sign_msgs = [b"m"] * ecdsa.SIGN_HOST_CROSSOVER
    ident = topology.new_identity("a01", address="loop://a01", key=rsa.generate(512, seed=1))

    def load_home(device="cuda"):
        import tempfile

        home = tempfile.mkdtemp()
        topology.save_home(home, ident, [ident.cert])
        return topology.load_home(home, device=device)

    def node(cls, *extra):
        # A node on a cpu crypt, built with no device of its own: the
        # default is cuda:0, which must raise here.
        from bftkv_tpu_torch.transport.loopback import LoopbackNet, TrLoopback

        graph, crypt, qs = topology.make_node(ident, [ident.cert], device="cpu")
        return cls(graph, qs, TrLoopback(crypt, LoopbackNet()), crypt, *extra)

    def open_client():
        import tempfile

        home = tempfile.mkdtemp()
        topology.save_home(home, ident, [ident.cert])
        return api.open_client(home, lambda crypt: None, join=False)

    def home():
        import tempfile

        path = tempfile.mkdtemp()
        topology.save_home(path, ident, [ident.cert])
        return path

    def gateway():
        from bftkv_tpu_torch.gateway import Gateway
        from bftkv_tpu_torch.transport.loopback import LoopbackNet, TrLoopback

        graph, crypt, qs = topology.make_node(ident, [ident.cert], device="cpu")
        return Gateway(graph, qs, TrLoopback(crypt, LoopbackNet()), crypt)

    def workload_worker():
        import tempfile

        from bftkv_tpu_torch.workload import driver

        out = os.path.join(tempfile.mkdtemp(), "w.json")
        return driver._worker_main(["--home", home(), "--spec", "write_heavy", "--worker", "0",
                                    "--workers", "1", "--out", out])

    def run_multiprocess():
        import tempfile

        from bftkv_tpu_torch.workload import WorkloadSpec, driver

        class _Cluster:
            universe = None

        return driver.run_multiprocess(WorkloadSpec(), _Cluster(), tempfile.mkdtemp(), procs=1)

    def spawn():
        import tempfile

        from bftkv_tpu_torch.cmd import run_cluster

        return run_cluster.spawn([home()], os.path.join(tempfile.mkdtemp(), "dbs"))

    def chaos_cluster():
        from bftkv_tpu_torch.faults.harness import build_cluster

        return build_cluster(4, 1, 4, bits=512)

    def sidecar_harness():
        from bftkv_tpu_torch.faults.nemesis import SidecarHarness

        return SidecarHarness()

    def nemesis_main():
        from bftkv_tpu_torch.faults import nemesis

        return nemesis.main(["--seed", "7", "--steps", "1"])

    from bftkv_tpu_torch.cmd import bftkv as bftkv_cmd
    from bftkv_tpu_torch.cmd import bftrw as bftrw_cmd
    from bftkv_tpu_torch.cmd import run_gateway as run_gateway_cmd
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
        "tally_counts": lambda: tally.counts(np.ones((2, 3), bool), np.ones((4, 3), bool),
                                             device="cuda"),
        "entry": lambda: entry.entry("cuda"),
        "flat_verify": lambda: entry.flat_verify(*(np.zeros((1, 1), np.float32),) * 8,
                                                 device="cuda"),
        "dryrun_multichip": lambda: entry.dryrun_multichip(2, "cuda"),
        "shard_over": lambda: rns.shard_over(["cuda:0"]).__enter__(),
        "SidecarService": lambda: verify_sidecar.SidecarService(device="cuda"),
        "serve": lambda: verify_sidecar.serve("127.0.0.1:0", device="cuda"),
        "BatchModExp_shared": lambda: modexp.BatchModExp.shared("cuda"),
        "AuthClient": lambda: auth.AuthClient(b"pw", 3, 2, device="cuda"),
        "AuthServer": lambda: auth.AuthServer(auth.AuthParams(1, 2, 3, b"s").serialize(), b"p",
                                              device="cuda"),
        "generate_partial_auth_params": lambda: auth.generate_partial_auth_params(
            b"pw", 4, 3, device="cuda"),
        "CollectiveSignature": lambda: signature.CollectiveSignature(device="cuda"),
        "new_crypto": lambda: new_crypto(device="cuda"),
        "ThresholdInstance": lambda: ThresholdInstance(None, device="cuda"),
        "RSAThreshold": lambda: trsa.RSAThreshold(device="cuda"),
        "threshold_dsa_new": lambda: tdsa.new(None, device="cuda"),
        "threshold_ecdsa_new": lambda: tecdsa.new(None, device="cuda"),
        "make_node": lambda: topology.make_node(ident, [ident.cert], device="cuda"),
        "load_home": load_home,
        "Server": lambda: node(Server, MemStorage()),
        "Client": lambda: node(Client),
        "open_client": open_client,
        "cmd_bftkv": lambda: bftkv_cmd.main(["--home", home(), "--storage", "mem"]),
        "cmd_bftrw": lambda: bftrw_cmd.main(["--home", home(), "--no-join", "read", "x"]),
        "cmd_run_gateway": lambda: run_gateway_cmd.main(["--home", home()]),
        "workload_worker": workload_worker,
        "run_multiprocess": run_multiprocess,
        "run_cluster_spawn": spawn,
        "Gateway": gateway,
        "build_cluster": chaos_cluster,
        "SidecarHarness": sidecar_harness,
        "nemesis_main": nemesis_main,
    }


ENTRY_POINTS = [
    "AuthClient", "AuthServer", "BatchModExp", "BatchModExp_shared", "Client",
    "CollectiveSignature", "Gateway", "ModexpDispatcher", "RSAThreshold", "Server",
    "SidecarHarness", "SidecarService", "SignDispatcher", "SignerDomain", "SignerDomain_limb",
    "ThresholdInstance", "VerifierDomain", "VerifierDomain_limb", "VerifierDomain_pallas",
    "VerifyDispatcher", "build_cluster", "calibration", "cmd_bftkv", "cmd_bftrw",
    "cmd_run_gateway", "consts_from_numpy", "dryrun_multichip", "ec_rns_engine",
    "ec_rns_scalar_mult_hosts", "ec_scalar_mult_hosts", "ecdsa_sign_batch",
    "ecdsa_verify_batch", "entry", "flat_verify", "generate_partial_auth_params",
    "key_rows_from_numpy", "limbs_from_numpy", "load_home", "make_node", "nemesis_main",
    "new_crypto", "open_client", "power_batch", "power_mod_rns", "run_cluster_spawn",
    "run_multiprocess", "serve", "shard_over", "tally_counts", "threshold_dsa_new",
    "threshold_ecdsa_new", "verify_batch_e65537", "verify_e65537_rns_indexed",
    "workload_worker",
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
        "BFTKV_SHARD",
        "BFTKV_DISPATCH_RECAL_S",
        "BFTKV_SIDECAR_SIGN",
        "BFTKV_SIDECAR_SPOT_RATE",
        "BFTKV_SIDECAR_BREAKER",
        "BFTKV_SIDECAR_MAX_INFLIGHT",
        "BFTKV_SIDECAR_MAX_QUEUE",
        "BFTKV_SIDECAR_MAX_WAIT",
        "BFTKV_SIDECAR_MAX_KEYS",
        "BFTKV_VERIFY_CACHE",
        "BFTKV_VERIFY_CACHE_MAX",
        "BFTKV_NATIVE_MODEXP",
        "BFTKV_NATIVE_CODEC",
        "BFTKV_REGION",
        "BFTKV_WAN_JITTER",
        "BFTKV_PLAIN_FSYNC",
        "BFTKV_PLAIN_CACHE",
        "BFTKV_STORAGE",
        "BFTKV_LOG_SEGMENT_MB",
        "BFTKV_LOG_GROUP_COMMIT_MS",
        "BFTKV_LOG_COMPACT_TRIGGER",
        "BFTKV_LOG_COMPACT_MBPS",
        # Transport, protocol and sync.
        "BFTKV_ADAPTIVE_FLOOR", "BFTKV_ADAPTIVE_TIMEOUT", "BFTKV_FANOUT_WORKERS",
        "BFTKV_HEDGE", "BFTKV_HEDGE_CAP", "BFTKV_HEDGE_MIN", "BFTKV_HTTP_POOL",
        "BFTKV_HTTP_TIMEOUT", "BFTKV_INLINE_FANOUT", "BFTKV_PEER_CB",
        "BFTKV_PEER_CB_OPEN_SECS", "BFTKV_PEER_CB_THRESHOLD", "BFTKV_PIGGYBACK",
        "BFTKV_PRESESSION", "BFTKV_REGION_RANK", "BFTKV_REPAIR", "BFTKV_REPAIR_AFTER",
        "BFTKV_RPC_BACKOFF", "BFTKV_RPC_RETRIES", "BFTKV_RPC_TIMEOUT", "BFTKV_SIGN_FANOUT",
        "BFTKV_WRITE_CHUNK", "BFTKV_WRITE_PIPELINE",
        # The process surfaces.
        "BFTKV_PROFILE", "BFTKV_PROFILE_HZ", "BFTKV_GIL_SAMPLER", "BFTKV_REGION_LEASE_S",
        "BFTKV_WORKLOAD_SEED", "BFTKV_WORKLOAD_RATE", "BFTKV_WORKLOAD_DURATION",
        "BFTKV_WORKLOAD_PROCS",
        # The health plane and the chaos nemesis.
        "BFTKV_SLO_WRITE_P99", "BFTKV_SLO_BURN_SCRAPES", "BFTKV_FLIGHT_RECORDER",
        "BFTKV_RECORDER_DIR", "BFTKV_RECORDER_MIN_INTERVAL", "BFTKV_RECORDER_MAX_MB",
        "BFTKV_SAT_THRESHOLD", "BFTKV_SAT_SCRAPES", "BFTKV_SAT_WAIT_REF",
        "BFTKV_WAN_RTT_MATRIX", "BFTKV_WORKLOAD",
        # The topology autopilot.
        "BFTKV_AUTOPILOT",
    }
    # Every declared flag is read somewhere in the port, and no BFTKV_*
    # name is read from the environment outside flags.py.
    blob = "\n".join(p.read_text() for p in _port_files() if p.name != "flags.py")
    assert [n for n in flags.declared() if n not in blob] == []
    pat = re.compile(r"(?:environ(?:\.get)?\s*[\(\[]|getenv\s*\()\s*f?['\"]BFTKV_")
    assert not [p for p in _port_files() if p.name != "flags.py" and pat.search(p.read_text())]


def test_flags_of_the_protocol_layer_keep_the_reference_defaults():
    from bftkv_tpu import flags as ref_flags

    names = [n for n in flags.declared() if n.startswith(
        ("BFTKV_ADAPTIVE", "BFTKV_HEDGE", "BFTKV_HTTP", "BFTKV_PEER_CB", "BFTKV_RPC",
         "BFTKV_REPAIR", "BFTKV_WRITE_", "BFTKV_PIGGYBACK", "BFTKV_PRESESSION",
         "BFTKV_REGION_RANK", "BFTKV_SIGN_FANOUT", "BFTKV_INLINE_FANOUT",
         "BFTKV_FANOUT_WORKERS"))]
    assert len(names) == 23
    for n in names:
        port, ref = flags.declared()[n], ref_flags.FLAGS[n]
        assert (port.default, port.kind) == (ref.default, ref.kind), n


def test_a_node_on_a_crypt_of_another_device_is_refused():
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.crypto import rsa
    from bftkv_tpu_torch.protocol.client import Client
    from bftkv_tpu_torch.transport.loopback import LoopbackNet, TrLoopback

    ident = topology.new_identity("a01", address="loop://a01", key=rsa.generate(512, seed=1))
    graph, crypt, qs = topology.make_node(ident, [ident.cert], device="cpu")
    crypt.collective.verifier.device = torch.device("meta")
    with pytest.raises(ValueError, match="crypt verifies on"):
        Client(graph, qs, TrLoopback(crypt, LoopbackNet()), crypt, device="cpu")
