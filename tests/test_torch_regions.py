"""The port's region plane (``bftkv_tpu_torch/regions/``) against the
reference's.

The first part rewrites the cases of ``tests/test_regions.py`` that start
no cluster (the region map, the RTT matrix grammar, the link-delay program
on the port's failpoint plane, region labels across ``build_universe`` and
the home directory); the gray-baseline and staging cases need the port's
transport and protocol, a later slice.  The last part holds the two
packages to the same answers: lookups, matrices, delay rules, and a
``regions`` file written by one package and merged by the other.
"""

from __future__ import annotations

import functools

import pytest

from bftkv_tpu_torch import regions as rg
from bftkv_tpu_torch import topology
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.regions.topology import NAMED, RttMatrix, install_matrix

BITS = 1024


@functools.lru_cache(maxsize=None)
def _keys(n):
    return tuple(rsa.generate(BITS, seed=7000 + i) for i in range(n))


@pytest.fixture(autouse=True)
def _clean_region_plane():
    rg.clear()
    yield
    fp.disarm()
    rg.clear()


# -- region map -------------------------------------------------------------


def test_empty_map_is_the_loopback_world():
    assert not rg.regionmap.installed()
    assert rg.region_of("a01") is None
    # In the loopback world every lookup is None, and None-vs-None is
    # local — region-aware sort keys collapse to a constant.
    assert rg.regionmap.rank(None, None) == 0.0
    assert rg.regionmap.rank("r0", None) == 0.0
    assert rg.regionmap.regions() == []


def test_install_indexes_names_and_link_ids():
    rg.install({"a01": "r0", "http://127.0.0.1:6001": "r1"})
    assert rg.region_of("a01") == "r0"
    # Address resolves in every form: verbatim, bare link id, and a
    # differently-pathed URL collapsing to the same link.
    assert rg.region_of("http://127.0.0.1:6001") == "r1"
    assert rg.region_of("127.0.0.1:6001") == "r1"
    assert rg.region_of("http://127.0.0.1:6001/path") == "r1"
    assert rg.region_of("unknown") is None
    assert rg.region_of(None) is None


def test_members_excludes_link_aliases():
    rg.install({"a01": "r0", "loop://a01": "r0", "a02": "r1"})
    assert rg.regionmap.members("r0") == ["a01"]
    assert rg.regionmap.regions() == ["r0", "r1"]


def test_rank_orders_by_rtt_when_matrix_installed():
    rg.install({"a": "r0", "b": "r1", "c": "r2"})
    assert rg.regionmap.rank("r0", "r0") == 0.0
    assert rg.regionmap.rank("r0", "r1") == 1.0  # no matrix: flat
    m = RttMatrix.parse("20/80/150", ["r0", "r1", "r2"])
    rg.regionmap.set_rtt(m)
    assert rg.regionmap.rank("r0", "r1") == pytest.approx(0.020)
    assert rg.regionmap.rank("r0", "r2") == pytest.approx(0.080)
    assert rg.regionmap.rank("r0", None) == 0.0  # unlabeled: local


# -- rtt matrix grammar -----------------------------------------------------


def test_matrix_pairwise_spec():
    m = RttMatrix.parse("20/80/150", ["r2", "r0", "r1"])  # unsorted in
    assert m.regions == ["r0", "r1", "r2"]
    assert m.intra_s == 0.0
    assert m.rtt("r0", "r1") == pytest.approx(0.020)
    assert m.rtt("r2", "r0") == pytest.approx(0.080)  # symmetric
    assert m.rtt("r1", "r2") == pytest.approx(0.150)
    assert m.min_cross_s() == pytest.approx(0.020)
    assert m.max_cross_s() == pytest.approx(0.150)


def test_matrix_intra_plus_pairwise_spec_and_named():
    m = RttMatrix.parse("wan2", ["r0", "r1"])
    assert NAMED["wan2"] == "20/60"
    assert m.intra_s == pytest.approx(0.020)
    assert m.rtt("r0", "r0") == pytest.approx(0.020)
    assert m.rtt("r0", "r1") == pytest.approx(0.060)
    assert m.name == "wan2"


def test_matrix_rejects_wrong_value_count_and_small_fleets():
    with pytest.raises(ValueError):
        RttMatrix.parse("20/80", ["r0", "r1", "r2"])  # 3 regions: 3 or 4
    with pytest.raises(ValueError):
        RttMatrix.parse("20", ["r0"])  # < 2 regions
    with pytest.raises(ValueError):
        RttMatrix.parse("not/a/spec", ["r0", "r1", "r2"])


# -- link-delay program + failpoint plane -----------------------------------


def test_delay_program_is_quiet_background_and_never_shadows_faults():
    rg.install({"a": "r0", "b": "r1"})
    reg = fp.arm(11)
    # One cross pair at 100 ms RTT → a 50 ms one-way rule each way.
    matrix, program = install_matrix(reg, "100", regions=["r0", "r1"])
    assert all(r.quiet and r.background for r in program.rules)
    assert len(program.rules) == 2
    act = reg._fire("transport.send", {"src": "a", "dst": "b"})
    assert act is not None and act.kind == "delay"
    assert act.params["seconds"] == pytest.approx(0.050)
    # Quiet: the fired delay is an environment, not a fault event.
    assert reg.trace() == []
    # Intra-region and unlabeled traffic never match.
    assert reg._fire("transport.send", {"src": "a", "dst": "a"}) is None
    assert reg._fire("transport.send", {"src": "", "dst": "b"}) is None
    # A foreground drop armed LATER at the same point wins the
    # first-match dispatch over the always-matching topology rule.
    reg.add("transport.send", "drop", match={"dst": "b"}, rule_id="cut")
    act = reg._fire("transport.send", {"src": "a", "dst": "b"})
    assert act is not None and act.kind == "drop"
    # The regionmap learned the matrix for distance ranking.
    assert rg.regionmap.rank("r0", "r1") == pytest.approx(0.100)
    assert matrix.min_cross_s() == pytest.approx(0.100)


def test_would_drop_is_side_effect_free_and_respects_budget():
    reg = fp.arm(7)
    rule = reg.add(
        "transport.send", "drop", match={"dst": "b"}, times=1,
        rule_id="once",
    )
    assert reg.would_drop("transport.send", dst="b")
    assert not reg.would_drop("transport.send", dst="a")
    # No side effects: budgets, draws, and the trace are untouched.
    assert rule._evals == 0 and rule._fires == 0
    assert reg.trace() == []
    # A spent fire budget stops matching — the probe sees the heal.
    assert reg._fire("transport.send", {"dst": "b"}).kind == "drop"
    assert not reg.would_drop("transport.send", dst="b")
    # Delay rules are not drops: geography never reads as a partition.
    reg.add("transport.send", "delay", seconds=0.01, rule_id="slow")
    assert not reg.would_drop("transport.send", dst="c")


# -- region labels across the topology plane --------------------------------


def test_build_universe_round_robin_and_home_roundtrip(tmp_path):
    uni = topology.build_universe(
        4, 2, 2, bits=BITS, n_gateways=1, n_regions=3, keys=_keys(9)
    )
    assert [i.region for i in uni.servers] == ["r0", "r1", "r2", "r0"]
    assert [i.region for i in uni.storage_nodes] == ["r0", "r1"]
    assert [i.region for i in uni.users] == ["r0", "r1"]
    assert [i.region for i in uni.gateways] == ["r0"]
    # Universe.regions maps names AND addresses.
    assert uni.regions["a02"] == "r1"
    assert uni.regions[uni.servers[1].cert.address] == "r1"
    # save_home writes the regions file; load_home merges it into the
    # process-global map (the localtrust pattern).
    ident = uni.users[0]
    home = str(tmp_path / ident.name)
    topology.save_home(
        home, ident, uni.view_of(ident), regions=uni.regions
    )
    rg.clear()
    topology.load_home(home, device="cpu")
    assert rg.region_of("a02") == "r1"
    assert rg.region_of(ident.name) == "r0"


# -- the same answers in both packages --------------------------------------

from bftkv_tpu import regions as ref_rg  # noqa: E402
from bftkv_tpu import topology as ref_topology  # noqa: E402
from bftkv_tpu.faults import failpoint as ref_fp  # noqa: E402
from bftkv_tpu.regions import topology as ref_rtop  # noqa: E402

MAPPING = {"a01": "r0", "a02": "r1", "loop://a03": "r2", "http://127.0.0.1:6004/x": "r1",
           "rw01": "r0", "": "r9", "u01": ""}
PROBES = ["a01", "a02", "a03", "loop://a03", "127.0.0.1:6004", "http://127.0.0.1:6004",
          "http://127.0.0.1:6004/y", "rw01", "u01", "zz", None, ""]


@pytest.fixture()
def _clean_both():
    ref_rg.clear()
    yield
    ref_fp.disarm()
    ref_rg.clear()


@pytest.mark.parametrize("spec", ["wan2", "wan3", "20/80/150", "5/20/80/150", "bad", "20"])
def test_region_map_and_matrices_equal_the_reference(_clean_both, spec):
    mine, theirs = rg.install(MAPPING), ref_rg.install(MAPPING)
    assert [mine.region_of(k) for k in PROBES] == [theirs.region_of(k) for k in PROBES]
    assert mine.regions() == theirs.regions()
    assert [mine.members(r) for r in mine.regions()] == [theirs.members(r) for r in mine.regions()]
    regions = ["r0", "r1"] if spec in ("wan2", "20") else ["r0", "r1", "r2"]
    try:
        want = ref_rtop.RttMatrix.parse(spec, regions)
    except ValueError:
        with pytest.raises(ValueError):
            RttMatrix.parse(spec, regions)
        return
    got = RttMatrix.parse(spec, regions)
    assert got.describe() == want.describe()
    mine.set_rtt(got)
    theirs.set_rtt(want)
    pairs = [(a, b) for a in regions + [None] for b in regions + [None]]
    assert [mine.rank(a, b) for a, b in pairs] == [theirs.rank(a, b) for a, b in pairs]
    assert [mine.rtt(a, b) for a, b in pairs] == [theirs.rtt(a, b) for a, b in pairs]


def test_delay_programs_equal_the_reference(_clean_both):
    labels = {"a": "r0", "b": "r1", "c": "r2"}
    rg.install(labels)
    ref_rg.install(labels)
    ends = [(s, d) for s in ("a", "b", "c", "") for d in ("a", "b", "c", "")]
    reg, ref_reg = fp.arm(5), ref_fp.arm(5)
    try:
        _, prog = install_matrix(reg, "wan3", jitter=0.5)
        _, ref_prog = ref_rtop.install_matrix(ref_reg, "wan3", jitter=0.5)
        assert [(r.rule_id, r.kind, r.params) for r in prog.rules] == [
            (r.rule_id, r.kind, r.params) for r in ref_prog.rules]
        for s, d in ends:
            a = reg._fire("transport.send", {"src": s, "dst": d})
            b = ref_reg._fire("transport.send", {"src": s, "dst": d})
            assert (a and (a.kind, a.params)) == (b and (b.kind, b.params)), (s, d)
        assert reg.trace() == [] and ref_reg.trace() == []
    finally:
        fp.disarm()
        ref_fp.disarm()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_regions_file_merges_in_the_other_package(tmp_path, _clean_both, writer):
    uni = topology.build_universe(4, 1, 1, bits=BITS, n_regions=2, keys=_keys(6))
    ident = uni.users[0]
    home = str(tmp_path / ident.name)
    save = topology.save_home if writer == "port" else ref_topology.save_home
    save(home, ident, uni.view_of(ident), regions=uni.regions)
    rg.clear()
    topology.load_home(home, device="cpu")
    ref_topology.load_home(home)
    keys = sorted(uni.regions) + ["zz"]
    assert [rg.region_of(k) for k in keys] == [ref_rg.region_of(k) for k in keys]
    assert [rg.region_of(k) for k in keys[:-1]] == [uni.regions[k] for k in keys[:-1]]
