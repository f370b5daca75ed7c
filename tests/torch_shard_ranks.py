"""Multi-rank harness of the port's sharded-engine tests: spawn ``world``
CPU ranks joined over gloo, run a batch of cases on every rank, and
return rank 0's results.

The ranks import only ``repro_torch`` (the cases carry the port's
scenarios ready-built), so spawning costs one torch import a rank.  A
process group starts from a ``FileStore`` under the test's ``tmp_path``,
so parallel test workers never fight over a TCP port, and the join has a
deadline: a hung rank fails the test instead of stalling the suite.
"""

from __future__ import annotations

import os
import pickle
import time


def _worker(rank, world, store_path, cases, out_path):
    import torch
    import torch.distributed as dist

    # the ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        results = [_run_case(case) for case in cases]
        if rank == 0:
            with open(out_path, "wb") as fh:
                pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()


def _run_case(case):
    """One case: ``("batch", scn, window, kwargs, obs_kind)`` through
    ``execute_sharded``, or ``("live", scn, window, kwargs, provenance)``
    through ``LiveLoop(engine="sharded")``.  Returns the result (or the
    overflow round) with the telemetry the test compares."""
    from repro_torch.core.vecsim import WindowOverflowError
    from repro_torch.core.vecsim.live import LiveLoop
    from repro_torch.core.vecsim.shard import execute_sharded
    from repro_torch.obs import CausalAuditor, EngineObs, FlightRecorder

    kind, scn, window, kw, telemetry = case
    if kind == "live":
        obs = EngineObs(histograms=True, spans=True)
        if telemetry:
            obs.flight = FlightRecorder(rate=1, sampler="all", live=True,
                                        auditor=CausalAuditor("fail"))
        rep = LiveLoop(scn, window, engine="sharded", device="cpu", obs=obs,
                       **kw).run()
        return dict(report=rep, hist=obs.latency_hist,
                    flight=obs.flight.export() if telemetry else None)
    obs = None
    if telemetry:
        obs = EngineObs(histograms=True)
        obs.flight = FlightRecorder(rate=1, seed=0, sampler="all")
    try:
        res = execute_sharded(scn, window, device="cpu", obs=obs, **kw)
    except WindowOverflowError as exc:
        return dict(overflow=exc.round)
    return dict(result=res,
                hist=None if obs is None else obs.latency_hist,
                flight=None if obs is None else obs.flight.export(),
                gauges=None if obs is None else obs.gauges)


def run_on_ranks(world, tmp_path, cases, timeout=600.0):
    """Rank 0's results of ``cases`` run on ``world`` spawned gloo
    ranks; raises if a rank fails or the deadline passes."""
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp_path), f"store_{world}")
    out = os.path.join(str(tmp_path), f"out_{world}.pkl")
    if os.path.exists(store):      # a store left by an earlier run
        os.remove(store)
    ctx = mp.start_processes(_worker, args=(world, store, cases, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world} ranks did not finish in "
                               f"{timeout} s")
    with open(out, "rb") as fh:
        return pickle.load(fh)
