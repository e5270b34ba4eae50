"""The runner of the paper's SNNs, served through ``repro_torch.serve``.

Set-up draws the weights and the pool of request images from the seed,
builds the registry and the runtime (``serve.build``), captures the
cell's buckets and serves a few full batches of each. A stretch is driven
by the mix's driver (``serve.driver``) through a client; every response
is kept in a ``serve.Log``. After the program's state is freed, every
response is judged against the reference the harness hands over,
``bench/reference/snn.py``, over the pool images served (``judge``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from bench.harness import judge, serve, traffic, weights


class Program:
    """The served SNN of one cell (``cell.Program``)."""

    new_log = serve.Log

    def __init__(self, env: SimpleNamespace, lap):
        cfg, mix = env.cfg, env.mix
        self.cfg, self.net = cfg, cfg["net"]
        self.drive_fn = serve.driver(env.cell["traffic"], mix, env.root)
        buckets = tuple(cfg["serve"]["buckets"])
        params, ths = weights.make(self.net, env.seed, env.dev)
        self.ref_weights = weights.copy(params, ths)
        lap("weights")
        self.pool = traffic.pool(cfg["dataset"], mix["pool"], env.seed)
        self.draws = traffic.Draws(env.seed, mix["pool"])
        lap("pool")
        self.rt, model, handle = serve.build(cfg, params, ths,
                                             chips=env.chips, device=env.dev)
        del params, ths
        lap("build")
        # a mix warms the largest bucket alone where it serves no other
        warm = buckets[-1:] if mix.get("warm") == "largest" else buckets
        handle.warmup(warm)
        lap("capture")
        self.client = serve.Client(self.rt, model, self.pool)
        self.client.warm(warm, self.draws)
        if env.dev.type == "cuda":
            torch.cuda.synchronize()
        lap("warm_steps")
        self.n_warm = len(self.client.pool_of_rid)

    def drive(self, log, *, mix, seed, start_s, seconds) -> dict:
        return self.drive_fn(self.client, self.draws, log, mix=mix,
                             seed=seed, start_s=start_s, seconds=seconds)

    def summary(self) -> dict:
        return self.rt.stats_summary()

    def host_phases(self, log: serve.Log) -> list[tuple]:
        """(name, t0, t1) on the perf_counter clock, in time order: per
        step the runtime's batch forming (with the call into the step),
        execution (copy in, replay, synchronize) and the pulls, pricing
        and response assembly, laid back from the step's return, and the
        client's own work between steps."""
        out = []
        for st in log.steps:
            service_s, price_s, t_call, t_done = st[3], st[4], st[6], st[7]
            e1 = t_done - price_s
            e0 = e1 - service_s
            out += [("runtime.batch_form", t_call, e0),
                    ("runtime.execute", e0, e1),
                    ("runtime.pull_price_respond", e1, t_done)]
        out += log.phases
        return sorted(out, key=lambda p: p[1])

    def release(self) -> None:
        self.n_taken = (len(self.client.pool_of_rid) - self.n_warm
                        - self.rt.pending())
        self.pool_of_rid = np.asarray(self.client.pool_of_rid, np.int64)
        self.rt = self.client = None

    def compare(self, window: serve.Log, traced: serve.Log | None,
                reference):
        served = window.arrays()
        if traced is not None:
            more = traced.arrays()
            served = {k: (np.concatenate([v, more[k]]) if v is not None
                          else None) for k, v in served.items()}
        used = np.unique(self.pool_of_rid[self.n_warm:])
        ref_params, ref_ths = self.ref_weights
        ref_out = reference.run_blocks(ref_params, ref_ths, self.net,
                                       self.pool[used],
                                       block=self.cfg["reference_block"])
        ref = judge.reference_answers(ref_out, self.net, used, len(self.pool))
        checks = judge.compare(served, self.pool_of_rid, self.n_taken, ref,
                               self.cfg["limits"])
        net = self.net
        # what the SNN's readers take besides the harness's fields: the
        # window's requests (rids, and latencies of an open loop), the
        # reference's answers by pool image, the net's stages, and the
        # traced stretch's requests
        ctx = dict(
            window_rids=(np.concatenate(window.rids) if window.rids
                         else np.zeros(0, np.int64)),
            latency_s=(np.concatenate(window.latency) if window.latency
                       else np.zeros(0)),
            pool_of_rid=self.pool_of_rid, ref=ref,
            stages=reference.plan(net["spec"], net["input_hw"],
                                  net["input_c"])[0],
            traced_rids=traced.rids if traced is not None else None)
        return SimpleNamespace(
            checks=checks, attempted=self.n_taken,
            failed=int(checks["missing"][0]),
            about=f"over the {len(used)} pool images served", ctx=ctx)
