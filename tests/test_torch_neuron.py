"""The port's neuron registry and per-step API, and ``spare_patterns``,
against the JAX package's.

- ``if_run`` / ``if_step`` on seeded currents for every registered mode,
  with and without ``leak``: spikes, membranes and latches bit-equal (fp32
  adds in the same order). The reference's own cases are
  ``tests/test_system.py``'s per-step tests.
- ``spare_patterns`` over a grid of widths and kernels, with the paper's 6
  at W=28, K=3.
- ``available_modes`` equal; ``unregister_neuron_model`` round-trips and,
  like every registry write, runs the ``_on_registry_change`` hooks (a
  no-op unregister runs none).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jencoding
from repro.core import neuron as jneuron
from repro_torch.core import encoding, neuron

MODES = neuron.available_modes()


def _currents(T=6, shape=(5, 7), seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0.2, 0.4, (T,) + shape).astype(np.float32)


@pytest.mark.parametrize("leak", [0.0, 0.05])
@pytest.mark.parametrize("mode", MODES)
def test_if_run_equals_the_reference(mode, leak):
    cur = _currents()
    got = neuron.if_run(torch.from_numpy(cur), 0.5, mode=mode, leak=leak)
    want = jneuron.if_run(jnp.asarray(cur), 0.5, mode=mode, leak=leak)
    assert got.dtype == torch.float32 and got.shape == cur.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.sum()) < got.numel()      # some spikes, not all


@pytest.mark.parametrize("mode", MODES)
def test_if_step_state_equals_the_reference(mode):
    cur = _currents(T=5, shape=(3, 4), seed=1)
    st = neuron.if_init((3, 4))
    jst = jneuron.if_init((3, 4))
    assert st.v_mem.dtype == torch.float32 and st.has_spiked.dtype == torch.bool
    for t in range(cur.shape[0]):
        st, s = neuron.if_step(st, torch.from_numpy(cur[t]), 0.3, mode=mode,
                               leak=0.02)
        jst, js = jneuron.if_step(jst, jnp.asarray(cur[t]), 0.3, mode=mode,
                                  leak=0.02)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(st.v_mem.numpy(), np.asarray(jst.v_mem))
        np.testing.assert_array_equal(st.has_spiked.numpy(),
                                      np.asarray(jst.has_spiked))


def test_spare_patterns_equal_the_reference():
    assert encoding.spare_patterns(28, 3) == 6       # the paper's count
    for width in range(1, 130):
        for kernel in (1, 2, 3, 5, 7, 9, 11):
            assert encoding.spare_patterns(width, kernel) == \
                jencoding.spare_patterns(width, kernel), (width, kernel)


def test_available_modes_equal_and_unregister_round_trips():
    assert neuron.available_modes() == jneuron.available_modes()
    calls = []
    neuron._on_registry_change.append(lambda: calls.append(1))
    try:
        base = neuron.get_neuron_model("mttfs")
        neuron.register_neuron_model("probe_neuron", base.fire,
                                     pool_latch_once=True)
        assert "probe_neuron" in neuron.available_modes()
        assert neuron.get_neuron_model("probe_neuron").pool_latch_once
        neuron.unregister_neuron_model("probe_neuron")
        assert "probe_neuron" not in neuron.available_modes()
        neuron.unregister_neuron_model("probe_neuron")   # absent: no-op
        with pytest.raises(ValueError, match="unknown neuron mode"):
            neuron.get_neuron_model("probe_neuron")
        assert calls == [1, 1]          # register + the one real removal
        sg = neuron.get_surrogate("triangle")
        neuron.register_surrogate("triangle", sg.primal, sg.grad,
                                  clamp_width=sg.clamp_width, overwrite=True)
        neuron.register_surrogate_fire(
            "mttfs", neuron._sg_fire_mttfs, overwrite=True)
        assert calls == [1, 1, 1, 1]    # surrogate writes run them too
    finally:
        neuron._on_registry_change.pop()
    assert neuron.available_modes() == jneuron.available_modes()
