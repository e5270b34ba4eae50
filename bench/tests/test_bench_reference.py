"""The benchmark's frozen reference against the program, on both paper
nets: on the CPU against ``queue_ref`` and ``queue_pallas`` (the kernels'
plain versions) for a few seeded images; on the card (marker ``cuda``)
against ``queue_pallas`` with B1 at a full bucket of 64.

Integer statistics and energies must be equal. Logits may differ only by
the classifier's float32 rounding: the reference multiplies each step's
spikes in one product, the program in fixed tiles of 256 rows, so the sums
of 1,152 products can round differently; 1e-5 is a few float32 ulps of
logits of magnitude ~1-10.
"""
import numpy as np
import pytest
import torch

from bench.harness import images, judge, traffic, weights
from bench.reference import energy, snn

LOGIT_TOL = 1e-5
NETS = {
    "cifar10": "32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10",
    "svhn": "1C3-32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-10",
}


def net(spec):
    return dict(spec=spec, input_hw=32, input_c=3, T=4, depth=64,
                mode="mttfs_cont", input_mode="analog", v_init_frac=0.5,
                compressed=True, vmem_resident=True)


def program(n, device, backend, imgs, params, ths):
    from repro_torch.core import engine
    from repro_torch.study.artifacts import StatsRecord
    from repro_torch.study.stages import price_record

    cfg = engine.SNNConfig(n["spec"], n["input_hw"], n["input_c"], T=n["T"],
                           mode=n["mode"], depth=n["depth"])
    logits, st = engine.infer_batch(params, ths, cfg, imgs, backend=backend,
                                    device=device)
    rec = StatsRecord(*(getattr(st, f).cpu().numpy()
                        for f in StatsRecord._fields))
    e = price_record(rec, input_hw=n["input_hw"])
    return logits.cpu(), rec, e


def check(n, out, logits, rec, e):
    for f in snn.STAT_FIELDS:
        assert np.array_equal(getattr(out, f).cpu().numpy(),
                              getattr(rec, f)), f
    assert (logits - out.logits.cpu()).abs().max().item() <= LOGIT_TOL
    ej, lat = energy.price(out.events_in.cpu(), out.spikes_out.cpu(),
                           out.add_ops.cpu(), input_hw=n["input_hw"],
                           compressed=True, vmem_resident=True)
    assert torch.equal(ej, e.total_j) and torch.equal(lat, e.latency_s)


@pytest.mark.parametrize("backend", ["queue_ref", "queue_pallas"])
@pytest.mark.parametrize("dataset", sorted(NETS))
def test_reference_equals_the_program_on_the_cpu(dataset, backend):
    n = net(NETS[dataset])
    params, ths = weights.make(n, 7, torch.device("cpu"))
    imgs = images.DATASETS[dataset](2, seed=11)[0]
    out = snn.run(params, ths, n, torch.as_tensor(imgs))
    assert out.overflow.sum() > 0 and out.events_in[:, 1].min() > 0
    check(n, out, *program(n, "cpu", backend, imgs, params, ths))


def test_the_pricing_matches_the_programs_word_format():
    from repro_torch.core import encoding

    for hw in (28, 32, 12, 64):
        for comp in (True, False):
            fmt = encoding.make_format(hw, 3, compressed=comp)
            assert energy.word_bytes(hw, comp) == encoding.word_nbytes(fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("dataset", sorted(NETS))
def test_reference_equals_b1_at_bucket_64(dataset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 has no CPU version")
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    n = net(NETS[dataset])
    for seed in (3, 2**31 + 9):
        params, ths = weights.make(n, seed, dev)
        imgs = traffic.pool(dataset, 64, seed)
        out = snn.run(*weights.copy(params, ths), n,
                      torch.as_tensor(imgs, device=dev))
        check(n, out, *program(n, None, "queue_pallas", imgs, params, ths))
        ref = judge.reference_answers(
            snn.Outputs(*(a.cpu() for a in out)), n, np.arange(64), 64)
        assert np.isfinite(ref["energy_j"]).all()
