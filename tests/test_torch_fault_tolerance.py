"""The port's fault-tolerance runtime (``repro_torch.runtime``) against the
JAX package's (``repro.runtime.fault_tolerance``).

- ``HeartbeatMonitor`` and ``StragglerDetector``: equal to the reference on
  the reference's own sequences and on seeded random ones (fixed seeds,
  and hypothesis where it is installed): dead hosts, flagged hosts, the
  EWMA, strikes and rebalanced shares, exactly.
- ``ElasticPlan.make``: equal to the reference over a grid of surviving
  device counts and model-parallel widths, on checkpoint directories that
  either package wrote (and an empty one).
- ``run_resilient`` on the ``dense-tied``, ``xlstm`` and ``moe`` smokes,
  from the reference's weights (``params_from_numpy``), on the same
  ``TokenStream`` with the same ``fail_at`` and ``ckpt_every``: the final
  step, the step each restore read, the committed checkpoint steps equal
  the reference's, and each loss of the history lies within
  ``tests/_lm_parity.py``'s loss tolerance (2^-10 of its value, the one
  ``test_torch_train_loop.py`` holds a step to) — the reference runs its
  unrolled path eagerly, as in those tests. A failure before the first
  checkpoint raises in both; the port resumes from a checkpoint the
  reference wrote, and continues as the reference does from it.
- Both packages reproduce the reference's resume quirk: the iterator is
  not rewound, so the rerun steps see the stream's next batches.
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from _prop import given, settings, st
from _smoke_archs import SMOKES
from _torch_archs import TORCH_SMOKES
from repro.checkpoint import checkpoint as jck
from repro.data.pipeline import TokenStream as JStream
from repro.models import model as JM
from repro.runtime import fault_tolerance as jft
from repro.training import train_loop as JTL
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import model as TM
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.training import train_loop as TTL

pytestmark = pytest.mark.filterwarnings(
    "ignore:The given NumPy array is not writable")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# heartbeats and stragglers
# ---------------------------------------------------------------------------

def _heartbeats(n_hosts, timeout, events):
    """dead_hosts / all_alive after each (advance, host) event, in both
    packages; host -1 beats nobody."""
    out = []
    for mod in (ft, jft):
        clock = FakeClock()
        mon = mod.HeartbeatMonitor(n_hosts=n_hosts, timeout_s=timeout,
                                   clock=clock)
        seen = []
        for adv, host in events:
            clock.t += adv
            if host >= 0:
                mon.beat(host)
            seen.append((mon.dead_hosts(), mon.all_alive()))
        out.append(seen)
    return out


def test_heartbeat_detects_dead_host_like_the_reference():
    ours, theirs = _heartbeats(4, 10, [(5, 0), (0, 1), (0, 3), (9, -1)])
    assert ours == theirs and ours[-1] == ([2], False)


@pytest.mark.parametrize("seed", range(6))
def test_heartbeats_equal_the_reference_on_random_sequences(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    events = [(float(rng.exponential(4.0)), int(rng.integers(-1, n)))
              for _ in range(40)]
    ours, theirs = _heartbeats(n, float(rng.uniform(1, 12)), events)
    assert ours == theirs


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 8), st.floats(0.5, 20),
       st.lists(st.tuples(st.floats(0, 15), st.integers(-1, 7)),
                max_size=30))
def test_heartbeats_equal_the_reference_hypothesis(n, timeout, events):
    events = [(a, h if h < n else -1) for a, h in events]
    ours, theirs = _heartbeats(n, timeout, events)
    assert ours == theirs


def _stragglers(n_hosts, factor, patience, alpha, rows):
    out = []
    for mod in (ft, jft):
        det = mod.StragglerDetector(n_hosts=n_hosts, factor=factor,
                                    patience=patience, alpha=alpha)
        seen = [(det.observe(np.asarray(r, dtype=float)), det.ewma.copy(),
                 det.strikes.copy(), det.rebalance_shares())
                for r in rows]
        out.append(seen)
    for (f1, e1, s1, w1), (f2, e2, s2, w2) in zip(*out):
        assert f1 == f2
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(w1, w2)
    return out[0]


def test_straggler_cases_of_the_reference():
    seen = _stragglers(4, 1.5, 3, 0.3, [[1.0, 1.0, 1.0, 3.0]] * 5)
    assert seen[-1][0] == [3]
    shares = seen[-1][3]
    assert shares[3] < shares[0] and abs(shares.sum() - 1.0) < 1e-9
    seen = _stragglers(2, 1.5, 2, 0.3, [[1.0, 4.0], [1.0, 1.0], [1.0, 1.0]])
    assert seen[-1][0] == []


@pytest.mark.parametrize("seed", range(6))
def test_stragglers_equal_the_reference_on_random_sequences(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 12))
    slow = rng.random(n) < 0.3
    rows = [rng.gamma(4.0, 0.25, n) * np.where(slow, 3.0, 1.0)
            for _ in range(25)]
    _stragglers(n, float(rng.uniform(1.2, 2.5)), int(rng.integers(1, 5)),
                float(rng.uniform(0.1, 0.9)), rows)


@settings(max_examples=40, deadline=None)
@given(st.integers(2, 8), st.floats(1.1, 3.0), st.integers(1, 4),
       st.floats(0.05, 0.95), st.integers(0, 2**31 - 1))
def test_stragglers_equal_the_reference_hypothesis(n, factor, patience,
                                                   alpha, seed):
    rng = np.random.default_rng(seed)
    _stragglers(n, factor, patience, alpha,
                [rng.uniform(0.1, 5.0, n) for _ in range(12)])


# ---------------------------------------------------------------------------
# ElasticPlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["none", "reference", "port"])
def test_elastic_plan_equals_the_reference(tmp_path, writer):
    tree = {"w": np.arange(6, dtype=np.float32)}
    if writer == "reference":
        jck.save(str(tmp_path), 5, tree)
        jck.save(str(tmp_path), 9, tree)
    elif writer == "port":
        ck.save(str(tmp_path), 7, {"w": torch.as_tensor(tree["w"])})
    for n in list(range(1, 70)) + [96, 128, 250, 256, 384, 511, 512]:
        for mp in (1, 3, 8, 16):
            got = ft.ElasticPlan.make(n, str(tmp_path), model_parallel=mp)
            want = jft.ElasticPlan.make(n, str(tmp_path), model_parallel=mp)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    plan = ft.ElasticPlan.make(24, str(tmp_path), model_parallel=16)
    assert plan.mesh_shape == (3, 8)
    assert plan.resume_step == {"none": 0, "reference": 9, "port": 7}[writer]


# ---------------------------------------------------------------------------
# run_resilient
# ---------------------------------------------------------------------------

def _steps_read(monkeypatch, module):
    """Record the step of every ``restore`` call ``module``'s
    run_resilient makes (a test-only patch)."""
    seen = []
    orig = module.restore

    def restore(root, template, **kw):
        out = orig(root, template, **kw)
        seen.append(out[1])
        return out

    monkeypatch.setattr(module, "restore", restore)
    return seen


def _run_both(arch, tmp_path, monkeypatch, *, seq, batch, ckpt_every,
              fail_at, max_steps, lr=1e-3):
    cfg = dataclasses.replace(SMOKES[arch], scan_layers=False)
    tcfg = TORCH_SMOKES[arch]
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    hp = dict(base_lr=lr, warmup=2, total_steps=20)
    out = {}
    for name, mod, step, state, stream in (
            ("ref", jft, JTL.make_train_step(cfg, **hp), JTL.init_state(jp),
             JStream(cfg.vocab, seq, batch)),
            ("port", ft, TTL.make_train_step(tcfg, **hp),
             TTL.init_state(tp), TokenStream(cfg.vocab, seq, batch,
                                             device="cpu"))):
        reads = _steps_read(monkeypatch, jck if name == "ref" else mod)
        root = tmp_path / name
        final, history = mod.run_resilient(
            train_step=step, state=state, batches=iter(stream),
            ckpt_root=str(root), ckpt_every=ckpt_every,
            fail_at={k: RuntimeError(v) for k, v in fail_at.items()},
            max_steps=max_steps)
        out[name] = dict(step=int(final.step), history=history,
                         reads=list(reads), root=root,
                         ckpts=jck.latest_step(str(root)),
                         committed=sorted(
                             p.name for p in root.iterdir()
                             if p.name.endswith(".COMMITTED")))
    return out


# relative loss tolerance of the steps after the first: 2^-10 (a step's,
# from one state) where no routing decides; MoE 2^-6, since over AdamW
# steps the two packages' weights drift by bf16 ulps and a flipped
# routing decision moves the smoke's 64-token loss by up to ~2^-8
DRIFT = {"dense-tied": 2.0 ** -10, "xlstm": 2.0 ** -10, "moe": 2.0 ** -6}


def _hold(out, drift):
    ref, port = out["ref"], out["port"]
    assert port["step"] == ref["step"]
    assert port["reads"] == ref["reads"]
    assert port["committed"] == ref["committed"]
    assert len(port["history"]) == len(ref["history"])
    r0, g0 = ref["history"][0], port["history"][0]
    assert abs(r0 - g0) <= 2.0 ** -10 * abs(r0), (r0, g0)
    for r, g in zip(ref["history"], port["history"]):
        assert abs(r - g) <= drift * abs(r), (r, g)


@pytest.mark.parametrize("arch,run", [
    # the reference's own case: failed at 7, restored from 5, reran 5..11
    ("dense-tied", dict(seq=32, batch=4, ckpt_every=5, fail_at={7: "x"},
                        max_steps=12)),
    ("xlstm", dict(seq=16, batch=2, ckpt_every=2, fail_at={3: "x"},
                   max_steps=4)),
    ("moe", dict(seq=16, batch=4, ckpt_every=2, fail_at={3: "x", 5: "y"},
                 max_steps=6)),
])
def test_run_resilient_matches_the_reference(arch, run, tmp_path,
                                             monkeypatch):
    out = _run_both(arch, tmp_path, monkeypatch, **run)
    _hold(out, DRIFT[arch])
    port = out["port"]
    assert port["step"] == run["max_steps"]
    fails = sorted(run["fail_at"])
    assert port["reads"] == [f - f % run["ckpt_every"] for f in fails]
    reruns = sum(f % run["ckpt_every"] for f in fails)
    assert len(port["history"]) == run["max_steps"] + reruns
    if arch == "dense-tied":
        assert port["history"][-1] < port["history"][0]


def test_run_resilient_reruns_on_the_next_batches(tmp_path):
    """The resume quirk, reproduced: after a restore the loop keeps the
    same iterator, so the rerun steps see new batches and the failing
    step's batch is consumed — the port's indices are the reference's."""
    seen = {}
    states = {
        "ref": JTL.TrainState(params={"w": np.zeros(2, np.float32)},
                              opt=np.zeros((), np.float32),
                              step=np.zeros((), np.int32)),
        "port": TTL.TrainState(params={"w": torch.zeros(2)},
                               opt=torch.zeros(()),
                               step=torch.zeros((), dtype=torch.int32))}
    for name, mod in (("ref", jft), ("port", ft)):
        used = []

        def step(state, batch, used=used):
            used.append(batch)
            return state._replace(step=state.step + 1), {"loss": 0.0}

        mod.run_resilient(train_step=step, state=states[name],
                          batches=iter(range(100)),
                          ckpt_root=str(tmp_path / name), ckpt_every=2,
                          fail_at={3: ValueError("x")}, max_steps=5)
        seen[name] = used
    assert seen["port"] == seen["ref"] == [0, 1, 2, 4, 5, 6]


def test_run_resilient_failure_before_checkpoint_raises(tmp_path):
    cfg, tcfg = SMOKES["xlstm"], TORCH_SMOKES["xlstm"]
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        ft.run_resilient(
            train_step=TTL.make_train_step(tcfg), state=TTL.init_state(tp),
            batches=iter(TokenStream(cfg.vocab, 16, 2, device="cpu")),
            ckpt_root=str(tmp_path / "port"), ckpt_every=50,
            fail_at={2: RuntimeError("early")}, max_steps=5)
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        jft.run_resilient(
            train_step=jax.jit(JTL.make_train_step(cfg)),
            state=JTL.init_state(jp), batches=iter(JStream(cfg.vocab, 16, 2)),
            ckpt_root=str(tmp_path / "ref"), ckpt_every=50,
            fail_at={2: RuntimeError("early")}, max_steps=5)


def test_other_exceptions_propagate(tmp_path):
    """Only RuntimeError and ValueError take the restore path."""
    state = TTL.TrainState(params={"w": torch.zeros(2)}, opt=torch.zeros(()),
                           step=torch.zeros((), dtype=torch.int32))
    with pytest.raises(KeyError):
        ft.run_resilient(train_step=lambda s, b: (s, {"loss": 0.0}),
                         state=state, batches=iter(range(9)),
                         ckpt_root=str(tmp_path), fail_at={0: KeyError("k")})


def test_port_resumes_from_a_reference_checkpoint(tmp_path, monkeypatch):
    """The reference trains 4 steps of the dense smoke with a checkpoint
    every 2 steps; the port, handed a fresh state, resumes from the
    reference's step-4 checkpoint and trains to 7, as the reference does
    from a copy of the same directory."""
    cfg = dataclasses.replace(SMOKES["dense-tied"], scan_layers=False)
    tcfg = TORCH_SMOKES["dense-tied"]
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    hp = dict(base_lr=1e-3, warmup=2, total_steps=20)
    jstep = JTL.make_train_step(cfg, **hp)
    root = tmp_path / "ref"
    jft.run_resilient(train_step=jstep, state=JTL.init_state(jp),
                      batches=iter(JStream(cfg.vocab, 32, 4)),
                      ckpt_root=str(root), ckpt_every=2, max_steps=4)
    shutil.copytree(root, tmp_path / "port")
    jreads = _steps_read(monkeypatch, jck)
    jfinal, jhist = jft.run_resilient(
        train_step=jstep, state=JTL.init_state(jp),
        batches=iter(JStream(cfg.vocab, 32, 4)), ckpt_root=str(root),
        ckpt_every=2, max_steps=7)
    treads = _steps_read(monkeypatch, ft)
    fresh, _ = TM.init_model(torch.Generator().manual_seed(9), tcfg,
                             device="cpu")
    tfinal, thist = ft.run_resilient(
        train_step=TTL.make_train_step(tcfg, **hp),
        state=TTL.init_state(fresh),
        batches=iter(TokenStream(cfg.vocab, 32, 4, device="cpu")),
        ckpt_root=str(tmp_path / "port"), ckpt_every=2, max_steps=7)
    assert treads == jreads == [4]
    assert int(tfinal.step) == int(jfinal.step) == 7
    assert len(thist) == len(jhist) == 3
    for r, g in zip(jhist, thist):
        assert abs(r - g) <= 2.0 ** -10 * abs(r), (r, g)
    for a, b in zip(jax.tree.leaves(jfinal.params),
                    jax.tree.leaves(tfinal.params)):
        assert a.shape == tuple(b.shape)
