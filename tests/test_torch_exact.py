"""The port's exact event engine (``repro_torch.core``: ``Network``, the
paper's Algorithms 1-3, the vector-clock baseline, the Spray overlay)
against the JAX package's ``repro.core``, step for step: the same
random schedules (the schedule runner of ``tests/test_properties.py``,
rebuilt over each package's ``Network`` with the same seeds), a Spray
overlay run and the Fig. 3 topology give equal traces (compared as plain
tuples, since the two packages' message classes are different types),
equal ``NetStats`` and equal delivery logs; and the port's ``run_exact``
equals ``repro.core.vecsim.crossval.run_exact`` on every scenario
builder at N in {64, 256} for protocols pc, r and vc — traces, stats,
delivered multisets, final clocks and the Fig. 7 graph snapshot at the
last churn round."""

import dataclasses
import random

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.vecsim import crossval as jcv
from repro_torch.core.vecsim import crossval as tcv
from repro_torch.core.vecsim import scenario_from_arrays
from vecsim_cases import BUILDERS


def _data(kind, data):
    if kind in ("broadcast", "deliver"):
        return (data.origin, data.counter, data.payload, data.vc)
    return data                       # link endpoint (open/close) or None


def trace_tuples(net):
    return [(t, kind, pid, _data(kind, data))
            for t, kind, pid, data in net.trace]


def logs(net):
    return {pid: [(m.origin, m.counter, m.payload, m.vc)
                  for m in proc.delivered_log]
            for pid, proc in net.procs.items()}


def assert_same_run(got, want):
    assert trace_tuples(got) == trace_tuples(want)
    assert vars(got.stats) == vars(want.stats)
    assert logs(got) == logs(want)
    assert got.time == want.time


def run_random_schedule(core, proto_factory, seed, n, n_ops, churn=True,
                        keep_ring=True):
    """``tests/test_properties.py``'s schedule runner over ``core``'s
    ``Network``."""
    rng = random.Random(seed)
    net = core.Network(seed=seed,
                       default_delay=lambda t, r: r.uniform(0.1, 4.0),
                       oob_delay=lambda t, r: r.uniform(0.05, 1.0))
    for pid in range(n):
        net.add_process(proto_factory(core, pid))
    core.ring_plus_random(net, range(n), k=3, rng=rng)
    for step in range(n_ops):
        net.run(until=net.time + rng.uniform(0.2, 1.5))
        op = rng.random()
        if op < 0.5 or not churn:
            net.procs[rng.randrange(n)].broadcast(("m", step))
        elif op < 0.75:
            a, b = rng.randrange(n), rng.randrange(n)
            if a != b and not net.has_link(a, b):
                net.connect(a, b)
        else:
            cands = [(a, b) for (a, b), lk in net.links.items()
                     if lk.alive and (not keep_ring or b != (a + 1) % n)]
            if cands:
                net.disconnect(*rng.choice(cands))
    net.run()
    return net


PROTOCOLS = {
    "pc": lambda core, pid: core.PCBroadcast(pid, ping_mode="flood"),
    "pc_always_gate": lambda core, pid: core.PCBroadcast(
        pid, ping_mode="flood", always_gate=True),
    "pc_route": lambda core, pid: core.PCBroadcast(pid, ping_mode="route"),
    "r": lambda core, pid: core.RBroadcast(pid),
    "bounded": lambda core, pid: core.BoundedPCBroadcast(
        pid, ping_mode="route", max_size=3, max_retry=8, ping_timeout=25.0),
    "vc": lambda core, pid: core.VCBroadcast(pid),
}
SCHEDULES = [(seed, 4 + (seed * 7) % 11, 8 + seed % 17)
             for seed in (1, 17, 256, 977, 1234, 2048, 4099, 5555, 8191,
                          9999)]


@pytest.mark.parametrize("proto", sorted(PROTOCOLS))
@pytest.mark.parametrize("seed,n,n_ops", SCHEDULES)
def test_random_schedule_equals_reference(proto, seed, n, n_ops):
    want = run_random_schedule(jcore, PROTOCOLS[proto], seed, n, n_ops)
    got = run_random_schedule(tcore, PROTOCOLS[proto], seed, n, n_ops)
    assert_same_run(got, want)
    assert tcore.check_trace(got.trace, all_pids=set(range(n))).summary() \
        == jcore.check_trace(want.trace, all_pids=set(range(n))).summary()
    if proto == "vc":
        for pid in range(n):
            g, w = got.procs[pid], want.procs[pid]
            assert (g.vc, g.comparisons, g.max_pending,
                    g.local_space_entries()) == (
                w.vc, w.comparisons, w.max_pending, w.local_space_entries())


@pytest.mark.parametrize("proto", ["pc", "r", "vc"])
def test_spray_overlay_equals_reference(proto):
    def spray_run(core):
        net = core.Network(seed=11, default_delay=lambda t, r: r.uniform(
            0.5, 2.0), oob_delay=0.3)
        n = 24
        for pid in range(n):
            net.add_process(PROTOCOLS[proto](core, pid))
        core.ring_plus_random(net, range(n))
        spray = core.SprayOverlay(net, range(n), period=5.0)
        spray.start()
        for i in range(30):
            net.call_later(0.7 * i, lambda i=i: net.procs[
                (7 * i) % n].broadcast(("s", i)))
        net.run(until=40.0)
        spray.stop()
        net.run()
        return net, spray

    want, wspray = spray_run(jcore)
    got, gspray = spray_run(tcore)
    assert_same_run(got, want)
    assert (gspray.exchanges, gspray.links_added, gspray.links_removed) == (
        wspray.exchanges, wspray.links_added, wspray.links_removed)
    assert gspray.exchanges > 0 and gspray.links_added > 0


@pytest.mark.parametrize("proto", ["r", "pc"])
def test_fig3_topology_equals_reference(proto):
    """Fig. 3: a fast shortcut added while the first message crawls; the
    R-broadcast run violates causal order, the PC-broadcast one gates
    the link — in both packages, event for event."""
    def fig3(core):
        cls = core.RBroadcast if proto == "r" else core.PCBroadcast
        net = core.Network(seed=3, default_delay=5.0, oob_delay=0.1)
        for pid in range(3):
            net.add_process(cls(pid))
        a, b, d = 0, 1, 2
        net.connect(a, b)
        net.connect(b, d)
        net.connect(b, a)
        net.connect(d, b)
        net.procs[a].broadcast("a")
        net.run(until=1.0)
        net.connect(a, d, delay=0.1)
        net.procs[a].broadcast("a'")
        net.run()
        return net

    want, got = fig3(jcore), fig3(tcore)
    assert_same_run(got, want)
    rep = tcore.check_trace(got.trace, all_pids={0, 1, 2})
    assert rep.causal_ok == (proto == "pc")
    assert rep.summary() == jcore.check_trace(
        want.trace, all_pids={0, 1, 2}).summary()


def test_control_bytes_wire_model():
    for core in (jcore, tcore):
        assert core.control_bytes(core.AppMsg(1, 2)) == 16
        assert core.control_bytes(core.AppMsg(1, 2, vc=((1, 2), (3, 4)))) \
            == 32
        assert core.control_bytes(core.Ping(0, 1, 7)) == 24
        assert core.control_bytes(core.Pong(0, 1, 7)) == 24
        assert core.control_bytes("payload") == 0
    rng = random.Random(5)
    for fn in (tcore.constant_delay(2.5), tcore.uniform_delay(1.0, 3.0)):
        assert 1.0 <= fn(0.0, rng) <= 3.0
    assert tcore.view_size(50_000) == jcore.view_size(50_000)


def port_scenario(ref):
    return scenario_from_arrays({f.name: getattr(ref, f.name)
                                 for f in dataclasses.fields(ref)})


@pytest.mark.parametrize("proto", ["pc", "r", "vc"])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("n", [64, 256])
def test_run_exact_equals_reference(builder, n, proto):
    ref = BUILDERS[builder](3, n)
    snap = int(ref.add_round[-1]) if ref.n_adds else None
    want = jcv.run_exact(ref, seed=2, protocol=proto, snapshot_round=snap)
    got = tcv.run_exact(port_scenario(ref), seed=2, protocol=proto,
                        snapshot_round=snap)
    assert_same_run(got, want)
    assert tcv.delivered_multiset_exact(got) == \
        jcv.delivered_multiset_exact(want)
    if proto == "vc":
        assert tcv.final_clocks_exact(got) == jcv.final_clocks_exact(want)
    if snap is not None:
        assert got.snapshot_graphs == want.snapshot_graphs
    else:
        assert not hasattr(got, "snapshot_graphs")
