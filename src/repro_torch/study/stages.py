"""The staged Study pipeline: train → convert → collect → price → report
(port of ``repro.study.stages``).

- :func:`train`    — the shared CNN trainer (:func:`fit_cnn`: fake-quant
                     AdamW through autograd), cached by a content hash of
                     the full training config + data;
- :func:`convert`  — ANN→SNN weight normalization + threshold balancing,
                     cached per (params, calibration data, options);
- :func:`collect`  — one batched inference pass over the eval set through
                     ``engine.infer_batch`` on the spec's backend, emitting
                     raw per-sample :class:`~.artifacts.StatsRecord` rows;
- :func:`price`    — energy/latency/FPS-per-W from the recorded stats, so
                     sweeps over ``compressed`` / ``vmem_resident`` /
                     ``weight_bits`` never re-run SNN inference;
- :func:`run`      — the whole chain for one :class:`StudySpec`;
  :func:`sweep`    — ``run`` over variants with shared artifacts.

``train``, ``convert``, ``collect`` and ``run`` take ``device=``: ``None``
means the card (``device.resolve_device``), ``"cpu"`` runs there on
request. Params and thresholds stay tensors on that device from stage to
stage; the cache keys carry no device, so they are the reference's keys.
The port's ``train`` draws its init from ``torch.Generator().manual_seed(
init_seed)``, so its trained net differs from the reference's for the same
key; the reference's ``train_*.pkl`` payload (same key, numpy lists) loads
here unchanged.

- :func:`train_snn` — in place of ``convert`` when ``spec.training ==
                     "direct"``: surrogate-gradient training through the
                     engine's dense plan (``training.surrogate.fit_snn``);
- :func:`export_artifact` / :func:`load_artifact` — a convert or
                     train_snn artifact as a standalone checkpoint
                     directory, verified on load.

``stage_counts`` tallies stage *executions* (cache misses), as there.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile

import numpy as np
import torch

from .. import obs
from ..checkpoint.checkpoint import restore as ckpt_restore
from ..checkpoint.checkpoint import save as ckpt_save
from ..core import conversion, encoding, engine
from ..core.cnn_baseline import (cnn_costs, cnn_forward, fraction_f32,
                                 make_train_step)
from ..core.energy import STATIC_POWER_W, cnn_energy, reprice
from ..core.snn_model import init_params, params_to_numpy
from ..device import resolve_device
from ..training import surrogate as surrogate_training
from .artifacts import (CollectArtifact, ConvertArtifact, DirectTrainArtifact,
                        StatsRecord, TrainArtifact)
from .cache import DEFAULT_CACHE, content_key
from .report import Report
from .spec import StudySpec

stage_counts: collections.Counter = collections.Counter()


def reset_stage_counts() -> None:
    stage_counts.clear()


def _params_on(params, device):
    """Params (tensors or the reference's numpy dicts) as float32 tensors
    on ``device``; tensors already there are not copied."""
    return engine.to_device(params, (), device)[0]


def _device_of(params) -> torch.device:
    """Where tensor params live (numpy params: the CPU)."""
    for layer in params:
        for v in layer.values():
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


def _thresholds_on(thresholds, device):
    return list(engine.to_device((), thresholds, device)[1])


def _f32_images(images):
    """Images as float32 (numpy stays numpy, a tensor stays a tensor), as
    the reference's ``jnp.asarray`` gives them to its content hash."""
    if isinstance(images, torch.Tensor):
        return images.to(torch.float32)
    return np.asarray(images, np.float32)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def fit_cnn(net: str, images, labels, *, epochs: int = 6, batch: int = 128,
            lr: float = 2e-3, weight_bits: int | None = 8,
            act_bits: int | None = 8, init_seed: int = 0, device=None):
    """The shared CNN training loop (FINN-style fake-quant AdamW).

    The epoch permutations are the reference's (``np.random.default_rng(
    epoch)``); the init is drawn from ``torch.Generator().manual_seed(
    init_seed)``. The training set is moved to ``device`` once, and cuDNN
    runs its deterministic algorithms, so one recipe trains one net.
    Returns ``(params, final_loss)``, the loss a 0-d tensor of the last
    step.
    """
    device = resolve_device(device)
    images = np.asarray(images)
    labels = np.asarray(labels)
    hw, c = images.shape[1], images.shape[-1]
    params = init_params(torch.Generator().manual_seed(init_seed), net, hw, c,
                         device=device)
    init_opt, step = make_train_step(net, weight_bits=weight_bits,
                                     act_bits=act_bits, lr=lr)
    opt = init_opt(params)
    x = torch.as_tensor(images, dtype=torch.float32, device=device)
    y = torch.as_tensor(labels, device=device)
    loss = None
    # cuDNN's fastest backward convs add with atomics, so two runs of one
    # recipe would train two nets under one cache key; its deterministic
    # algorithms train the same net every time
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for epoch in range(epochs):
            perm = torch.as_tensor(np.random.default_rng(epoch).permutation(
                len(images)), device=device)
            for i in range(0, len(images), batch):
                idx = perm[i : i + batch]
                params, opt, loss = step(params, opt,
                                         {"image": x[idx], "label": y[idx]})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return params, loss


def train(spec: StudySpec, *, cache=None, device=None) -> TrainArtifact:
    """Train (or fetch the cached) CNN for ``spec``'s dataset + recipe."""
    cache = cache or DEFAULT_CACHE
    device = resolve_device(device)
    images, labels = spec.load_train()
    key = content_key(
        "train-v1", spec.dataset, spec.net, spec.input_hw, spec.input_c,
        spec.epochs, spec.train_batch, spec.lr, spec.train_weight_bits,
        spec.train_act_bits, spec.init_seed, images, labels)

    def build():
        stage_counts["train"] += 1
        params, _ = fit_cnn(
            spec.net, images, labels, epochs=spec.epochs,
            batch=spec.train_batch, lr=spec.lr,
            weight_bits=spec.train_weight_bits, act_bits=spec.train_act_bits,
            init_seed=spec.init_seed, device=device)
        return TrainArtifact(params, images, labels, key)

    art = cache.get_or_build(
        "train", key, build, tag=spec.dataset,
        save=lambda a: params_to_numpy(a.params),
        load=lambda p: TrainArtifact(_params_on(p, device), images, labels,
                                     key))
    return art._replace(params=_params_on(art.params, device))


def from_params(params) -> TrainArtifact:
    """Wrap caller-trained params (tensors, or the reference's numpy
    dicts) as a train artifact (the shim's entry)."""
    return TrainArtifact(params, None, None, content_key("params-v1", params))


def _host_thresholds(thresholds):
    return [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in thresholds]


def _save_snn(a):
    """A convert / train_snn artifact as the reference's numpy payload."""
    return {"snn_params": params_to_numpy(a.snn_params),
            "thresholds": _host_thresholds(a.thresholds)}


# ---------------------------------------------------------------------------
# train_snn (direct surrogate-gradient training — the convert alternative)
# ---------------------------------------------------------------------------

def train_snn(spec: StudySpec, *, cache=None,
              device=None) -> DirectTrainArtifact:
    """Train the SNN directly with surrogate gradients (``training="direct"``).

    Sits where ``convert`` sits in the pipeline — its artifact is
    field-compatible, so ``collect`` / ``price`` consume it unchanged — but
    the weights come from :func:`~repro_torch.training.surrogate.fit_snn`,
    autograd through the engine's own dense plan. The key is the
    reference's: it covers the dynamics fields (T, mode, input encoding),
    because the net is trained through them. Cached like ``train`` (the
    same numpy payload, so the two packages' ``train_snn_*.pkl`` files are
    interchangeable); executions are tallied in ``stage_counts["train_snn"]``
    and optimizer steps in ``training.surrogate.step_counts``.
    """
    cache = cache or DEFAULT_CACHE
    device = resolve_device(device)
    images, labels = spec.load_train()
    key = content_key(
        "train-snn-v1", spec.dataset, spec.net, spec.input_hw, spec.input_c,
        spec.T, spec.mode, spec.input_mode, spec.input_theta,
        spec.v_init_frac, spec.snn_epochs, spec.snn_batch, spec.snn_lr,
        spec.surrogate, spec.sg_beta, spec.loss_target, spec.rate_reg,
        spec.snn_init_seed, images, labels)

    def build():
        stage_counts["train_snn"] += 1
        params, thresholds, _ = surrogate_training.fit_snn(
            spec.net, images, labels, T=spec.T, mode=spec.mode,
            input_mode=spec.input_mode, input_theta=spec.input_theta,
            v_init_frac=spec.v_init_frac, epochs=spec.snn_epochs,
            batch=spec.snn_batch, lr=spec.snn_lr, target=spec.loss_target,
            rate_reg=spec.rate_reg, surrogate=spec.surrogate,
            beta=spec.sg_beta, init_seed=spec.snn_init_seed, device=device)
        return DirectTrainArtifact(params, thresholds, key)

    def load(p):
        return DirectTrainArtifact(_params_on(p["snn_params"], device),
                                   _thresholds_on(p["thresholds"], device),
                                   key)

    art = cache.get_or_build("train_snn", key, build, tag=spec.dataset,
                             save=_save_snn, load=load)
    return art._replace(snn_params=_params_on(art.snn_params, device),
                        thresholds=_thresholds_on(art.thresholds, device))


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def convert(spec: StudySpec, trained: TrainArtifact | None = None, *,
            calib_images=None, cache=None, device=None) -> ConvertArtifact:
    """ANN→SNN conversion: normalized weights + (balanced) thresholds.

    The cache key covers what the thresholds depend on — the trained
    params, the calibration pixels, the percentile and, when balancing,
    the neuron dynamics fields — as the reference's key does, so a pricing
    or queue-depth sweep converts once.
    """
    cache = cache or DEFAULT_CACHE
    device = resolve_device(device)
    if trained is None:
        trained = train(spec, cache=cache, device=device)
    if calib_images is None:
        if trained.train_images is None:
            raise ValueError(
                "convert() needs calibration data: pass calib_images= when "
                "the TrainArtifact wraps caller-provided params "
                "(from_params) and carries no train split")
        calib = _f32_images(trained.train_images[: spec.n_calib])
    else:
        calib = _f32_images(calib_images)

    # keyed by the params *content* (not trained.key), so caller-provided
    # params (the run_study shim) and the train stage share one entry
    parts = ["convert-v1", trained.params, spec.net, spec.input_hw,
             spec.input_c, spec.percentile, spec.balance, calib]
    if spec.balance:
        parts += [spec.T, spec.mode, spec.input_mode, spec.input_theta,
                  spec.v_init_frac, spec.n_balance]
    key = content_key(*parts)

    def build():
        stage_counts["convert"] += 1
        params = _params_on(trained.params, device)
        calib_t = torch.as_tensor(calib, device=device)
        snn_params, thresholds = conversion.convert(
            params, spec.net, calib_t, spec.percentile)
        if spec.balance:
            thresholds = conversion.balance_thresholds(
                snn_params, thresholds, spec.snn_config(), params,
                calib_t[: spec.n_balance])
        return ConvertArtifact(snn_params, thresholds, key)

    def load(p):
        return ConvertArtifact(_params_on(p["snn_params"], device),
                               _thresholds_on(p["thresholds"], device), key)

    art = cache.get_or_build("convert", key, build, tag=spec.dataset,
                             save=_save_snn, load=load)
    return art._replace(snn_params=_params_on(art.snn_params, device),
                        thresholds=_thresholds_on(art.thresholds, device))


# ---------------------------------------------------------------------------
# export — hand a converted/trained SNN to the serving layer as files
# ---------------------------------------------------------------------------

_EXPORT_SCHEMA = "snn-export-v1"
_EXPORT_MANIFEST = "export.json"


def export_artifact(artifact: ConvertArtifact | DirectTrainArtifact,
                    root: str) -> str:
    """Write a convert/train_snn artifact as a standalone checkpoint.

    Params and thresholds land in a :mod:`repro_torch.checkpoint` directory
    with per-leaf digests, plus the reference's manifest (``export.json``)
    pinning the stage's content key, so :func:`load_artifact` can refuse a
    tampered or mismatched tree; each package loads what the other
    exported. Returns the manifest path.
    """
    thresholds = _host_thresholds(artifact.thresholds)
    tree = {"snn_params": [dict(p) for p in artifact.snn_params],
            "thresholds": thresholds}
    ckpt_save(root, 0, tree)
    manifest = {
        "schema": _EXPORT_SCHEMA,
        "key": artifact.key,
        "kind": type(artifact).__name__,
        "content": content_key("snn-export-content", artifact.snn_params,
                               thresholds),
        "params_tree": [sorted(p) for p in artifact.snn_params],
        "n_thresholds": len(artifact.thresholds),
    }
    path = os.path.join(root, _EXPORT_MANIFEST)
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_artifact(root: str, *,
                  device=None) -> ConvertArtifact | DirectTrainArtifact:
    """Restore an :func:`export_artifact` directory onto ``device``,
    verifying integrity.

    Raises ``FileNotFoundError`` without a manifest, ``IOError`` on a
    corrupted shard (the checkpoint layer's per-leaf digests), and
    ``ValueError`` when the restored content no longer hashes to the
    exported content key (stale or tampered export).
    """
    device = resolve_device(device)
    path = os.path.join(root, _EXPORT_MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_EXPORT_MANIFEST} under {root!r} — "
                                "not an export_artifact directory")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("schema") != _EXPORT_SCHEMA:
        raise ValueError(f"{path}: schema {manifest.get('schema')!r}, "
                         f"expected {_EXPORT_SCHEMA!r}")
    template = {"snn_params": [{k: 0 for k in layer}
                               for layer in manifest["params_tree"]],
                "thresholds": [0] * manifest["n_thresholds"]}
    tree, _ = ckpt_restore(root, template)
    cls = (DirectTrainArtifact if manifest["kind"] == "DirectTrainArtifact"
           else ConvertArtifact)
    got = content_key("snn-export-content", tree["snn_params"],
                      tree["thresholds"])
    if got != manifest["content"]:
        raise ValueError(
            f"{root}: restored params hash to {got} but the manifest pins "
            f"{manifest['content']} — export is stale or tampered; re-run "
            "export_artifact")
    return cls(_params_on(tree["snn_params"], device),
               _thresholds_on(tree["thresholds"], device), manifest["key"])


# ---------------------------------------------------------------------------
# collect
# ---------------------------------------------------------------------------

def collect(spec: StudySpec,
            converted: ConvertArtifact | DirectTrainArtifact | None = None, *,
            images=None, cache=None, device=None) -> CollectArtifact:
    """Run the SNN over the eval set once; record raw per-sample stats.

    The only stage that runs SNN inference: ``engine.infer_batch`` on
    ``spec.backend`` in batches of ``spec.batch`` (on the card,
    ``queue_pallas`` runs B1 in each event-driven conv stage, and
    ``queue_sparse`` with ``weight_bits`` B3 and the int8 head B2). The
    batches' outputs stay on the device until one transfer at the end. The
    key excludes every price-stage field, as the reference's does.
    """
    cache = cache or DEFAULT_CACHE
    device = resolve_device(device)
    if converted is None:
        converted = (train_snn(spec, cache=cache, device=device)
                     if spec.training == "direct"
                     else convert(spec, cache=cache, device=device))
    if images is None:
        images, _ = spec.load_eval()
    images = _f32_images(images)

    key = content_key(
        "collect-v2", converted.key, spec.net, spec.input_hw, spec.input_c,
        spec.T, spec.depth, spec.mode, spec.input_mode, spec.input_theta,
        spec.v_init_frac, spec.backend, spec.batch,
        spec.executed_weight_bits(), images)

    def build():
        stage_counts["collect"] += 1
        cfg = spec.snn_config()
        params = _params_on(converted.snn_params, device)
        ths = _thresholds_on(converted.thresholds, device)
        x = torch.as_tensor(images, device=device)
        logits_all, stats_all = [], []
        for i in range(0, x.shape[0], spec.batch):
            logits, stats = engine.infer_batch(
                params, ths, cfg, x[i : i + spec.batch],
                backend=spec.backend, device=device)
            logits_all.append(logits)
            stats_all.append(stats)
        logits = torch.cat(logits_all)
        preds = torch.argmax(logits, -1).to(torch.int32)
        record = StatsRecord(**{
            f: torch.cat([getattr(s, f) for s in stats_all]).cpu().numpy()
            for f in StatsRecord._fields})
        images_np = (images.cpu().numpy() if isinstance(images, torch.Tensor)
                     else images)
        return CollectArtifact(images_np, logits.cpu().numpy(),
                               preds.cpu().numpy(), record, key)

    return cache.get_or_build("collect", key, build,
                              tag=f"{spec.dataset}-{spec.backend}")


# ---------------------------------------------------------------------------
# price
# ---------------------------------------------------------------------------

def price_record(record, *, input_hw: int, compressed: bool = True,
                 vmem_resident: bool = True):
    """Price a :class:`StatsRecord` (or any N-row slice of one).

    The word format is the kernel=3 AE format of the first conv at
    ``input_hw``, as in the reference, so pricing a sliced row bit-equals
    the same row of a whole-record pricing. ``vmem_resident`` prices the
    membrane potentials as resident on chip (the default) or streamed.
    Returns an :class:`~repro_torch.core.energy.EnergyBreakdown`.
    """
    fmt = encoding.make_format(input_hw, 3, compressed=compressed)
    return reprice(record, word_bytes=encoding.word_nbytes(fmt),
                   vmem_resident=vmem_resident)


@torch.no_grad()
def price(spec: StudySpec, collected: CollectArtifact,
          trained: TrainArtifact, labels) -> Report:
    """Price recorded stats under ``spec``'s pricing fields → :class:`Report`.

    The SNN side comes entirely from the record (:func:`price_record`); the
    CNN side re-runs the quantized forward on the params' device, because
    ``weight_bits`` changes it, and prices the static CNN costs.
    """
    # NOT in stage_counts: that counter tallies cache-missable stage
    # executions; price has no cache tier
    obs.counter("study.stage.price")
    with obs.span("study.price", dataset=spec.dataset, backend=spec.backend):
        return _price_impl(spec, collected, trained, labels)


def _price_impl(spec: StudySpec, collected: CollectArtifact,
                trained: TrainArtifact, labels) -> Report:
    device = _device_of(trained.params)
    params = _params_on(trained.params, device)
    images = torch.as_tensor(collected.images, device=device)
    labels_np = np.asarray(labels)

    # --- CNN side (static) ---
    logits_cnn = cnn_forward(params, spec.net, images,
                             weight_bits=spec.weight_bits,
                             act_bits=spec.weight_bits)
    cnn_pred = torch.argmax(logits_cnn, -1)
    hits = cnn_pred == torch.as_tensor(labels_np, device=cnn_pred.device)
    # audit: allow[host-sync] the report's accuracy is a Python float
    cnn_acc = fraction_f32(hits).item()
    cnn_pred = cnn_pred.cpu().numpy()
    costs = cnn_costs(params, spec.net, spec.input_hw, spec.input_c,
                      spec.weight_bits, spec.weight_bits)
    e_cnn = cnn_energy(costs, bits=spec.weight_bits)

    # --- SNN side: reprice the record ---
    record = collected.stats
    e = price_record(record, input_hw=spec.input_hw,
                     compressed=spec.compressed,
                     vmem_resident=spec.vmem_resident)

    snn_energy_j = e.total_j.numpy()
    snn_latency_s = e.latency_s.numpy()
    snn_pred = np.asarray(collected.snn_pred)
    # int32 accumulation, the reference's dtype and wrap semantics
    spikes_np = record.spikes_out.sum(-1, dtype=np.int32)
    events_np = record.events_in.sum(-1, dtype=np.int32)

    per_class = {
        int(k): float(spikes_np[labels_np == k].mean())
        for k in np.unique(labels_np)
    }

    snn_power = snn_energy_j / snn_latency_s
    snn_fpw = 1.0 / (snn_latency_s * (snn_power + STATIC_POWER_W))
    cnn_power = float(e_cnn.total_j / e_cnn.latency_s)
    cnn_fpw = 1.0 / (float(e_cnn.latency_s) * (cnn_power + STATIC_POWER_W))

    return Report(
        dataset=spec.dataset,
        cnn_acc=cnn_acc,
        snn_acc=float((snn_pred == labels_np).mean()),
        agreement=float((snn_pred == cnn_pred).mean()),
        snn_energy_j=snn_energy_j,
        cnn_energy_j=float(e_cnn.total_j),
        snn_latency_s=snn_latency_s,
        cnn_latency_s=float(e_cnn.latency_s),
        snn_fps_per_w=snn_fpw,
        cnn_fps_per_w=cnn_fpw,
        spikes_per_sample=spikes_np,
        events_per_sample=events_np,
        overflow=int(collected.stats.overflow.sum()),
        per_class_spikes=per_class,
        spec=spec,
    )


# ---------------------------------------------------------------------------
# end-to-end + sweeps
# ---------------------------------------------------------------------------

def run(spec: StudySpec, *, cache=None, device=None) -> Report:
    """The full staged pipeline for one spec (dataset-driven data), on
    ``device`` (``None``: the card)."""
    cache = cache or DEFAULT_CACHE
    trained = train(spec, cache=cache, device=device)
    if spec.training == "direct":
        converted = train_snn(spec, cache=cache, device=device)
    else:
        converted = convert(spec, trained, cache=cache, device=device)
    eval_images, eval_labels = spec.load_eval()
    collected = collect(spec, converted, images=eval_images, cache=cache,
                        device=device)
    return price(spec, collected, trained, eval_labels)


def run_with_data(spec: StudySpec, params, images, labels, calib_images, *,
                  cache=None, device=None) -> Report:
    """The staged pipeline over caller-provided params and arrays; content
    keys make it share every cache tier with the dataset-driven path."""
    cache = cache or DEFAULT_CACHE
    device = resolve_device(device)
    trained = from_params(params)
    trained = trained._replace(params=_params_on(trained.params, device))
    converted = convert(spec, trained, calib_images=calib_images, cache=cache,
                        device=device)
    collected = collect(spec, converted, images=images, cache=cache,
                        device=device)
    return price(spec, collected, trained, labels)


def sweep(base: StudySpec, variants, *, cache=None, device=None) -> list:
    """``run`` one report per variant dict; shared stages come from cache.

    A pricing-only sweep (``compressed`` / ``vmem_resident`` /
    ``weight_bits`` on a backend that does not execute it) trains,
    converts and collects once.
    """
    cache = cache or DEFAULT_CACHE
    return [run(base.replace(**v), cache=cache, device=device)
            for v in variants]
