"""StudySpec — the frozen, validated description of one study point (port
of ``repro.study.spec``: every field, default and named error of the
reference, and no device field, so every cache key stays the reference's).

A :class:`StudySpec` captures *everything* that determines a matched-budget
SNN-vs-CNN comparison (the paper's Sec. 4/5 methodology): dataset, network
spec, training recipe, conversion options, execution (T/depth/mode/backend)
and pricing options (compressed encoding, memory residency, bit widths).
It is hashable and cheap to ``dataclasses.replace``, which is how sweeps are
written: one base spec, N pricing variants, and the staged pipeline
(:mod:`.stages`) re-prices recorded stats instead of re-running
inference for variants that only differ in pricing fields.

Field groups and the stage whose cache key they feed:

======================  =====================================================
stage                   fields
======================  =====================================================
train                   dataset, net, input_hw/c, n_train, train_seed,
                        epochs, train_batch, lr, train_weight_bits,
                        train_act_bits, init_seed
convert                 percentile, n_calib, balance (+ T, mode, input_mode,
                        input_theta, v_init_frac when balance=True)
train_snn               training="direct" only: snn_epochs, snn_batch,
                        snn_lr, surrogate, sg_beta, loss_target, rate_reg,
                        snn_init_seed (+ T, mode, input encoding fields —
                        the dynamics are trained through)
collect                 T, depth, mode, input_mode, input_theta, v_init_frac,
                        backend, batch, n_eval, eval_seed (+ weight_bits on
                        the backends that execute it — see below)
price (never cached)    compressed, vmem_resident, weight_bits
======================  =====================================================

``weight_bits`` is a pure pricing axis on most backends, but the sparse
realization (``backend='queue_sparse'``, ref-anchored by ``queue_ref``)
*executes* it — int-quantized conv accumulate + int8 output head — so for
those backends it also keys the collect cache
(:meth:`StudySpec.executed_weight_bits`).

``compressed`` deliberately does *not* key the collect stage: the AE word
format only changes how many bits a stored event occupies (Sec. 5.2), never
which events exist or what the membrane dynamics compute, so the recorded
per-sample stats are bit-identical across compressed on/off.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass



class StudySpecError(ValueError):
    """A structurally invalid StudySpec (mirrors ``engine.SpecError``)."""


class UnknownDatasetError(StudySpecError):
    pass


class UnknownBackendError(StudySpecError):
    pass


class UnknownNeuronModeError(StudySpecError):
    pass


class UnknownInputModeError(StudySpecError):
    pass


@dataclass(frozen=True)
class StudySpec:
    # --- what is being studied -------------------------------------------
    dataset: str                      # key into data.synthetic.DATASETS
    net: str | None = None            # model spec string; None -> PAPER_SPECS
    input_hw: int | None = None       # None -> PAPER_SPECS[dataset]
    input_c: int | None = None

    # --- data sizes ------------------------------------------------------
    n_train: int = 2048
    n_eval: int = 256
    n_calib: int = 256                # conversion calibration samples
    train_seed: int = 1
    eval_seed: int = 99

    # --- train stage -----------------------------------------------------
    epochs: int = 6
    train_batch: int = 128
    lr: float = 2e-3
    train_weight_bits: int = 8        # FINN-style fake-quant during training
    train_act_bits: int = 8
    init_seed: int = 0

    # --- convert stage ---------------------------------------------------
    percentile: float = 99.0          # data-based normalization percentile
    balance: bool = True              # greedy threshold balancing
    n_balance: int = 128              # calibration samples used by balancing

    # --- how the SNN's weights come to be --------------------------------
    # "convert": ANN->SNN conversion of the trained CNN (the paper's
    # pipeline); "direct": surrogate-gradient training through the engine
    # (training.surrogate), which replaces convert with the train_snn
    # stage. The CNN baseline is trained either way.
    training: str = "convert"

    # --- train_snn stage (used only when training="direct") --------------
    snn_epochs: int = 4
    snn_batch: int = 128
    snn_lr: float = 5e-3
    surrogate: str = "superspike"     # core/neuron.py surrogate registry
    sg_beta: float = 10.0             # surrogate sharpness
    loss_target: str = "count"        # training.surrogate.VALID_TARGETS
    rate_reg: float = 0.0             # spike-rate regularizer weight
    snn_init_seed: int = 0

    # --- collect stage (SNN execution) -----------------------------------
    T: int = 4
    depth: int = 256                  # AEQ depth per (t, c, phase) segment
    mode: str = "mttfs_cont"          # neuron model (core/neuron.py registry)
    input_mode: str = "analog"
    input_theta: float = 0.1
    v_init_frac: float = 0.5
    backend: str = "dense"            # engine backend name
    batch: int = 64                   # inference batch size

    # --- price stage (re-priceable without re-running inference) ---------
    compressed: bool = True           # compressed AE word encoding (Sec. 5.2)
    vmem_resident: bool = True        # LUTRAM-analogue vs HBM (BRAM-analogue)
    weight_bits: int = 8              # deployed CNN bit width

    def __post_init__(self):
        from ..core import engine, neuron

        if not isinstance(self.dataset, str) or not self.dataset:
            raise UnknownDatasetError(
                f"dataset must be a non-empty string, got {self.dataset!r}")

        # resolve net/geometry defaults from the paper's model zoo. A spec
        # with explicit net + geometry tolerates a free-form dataset label
        # (the run_study shim labels caller-provided data); the name is
        # validated against the registry the moment it must *resolve*
        # anything — here, or in load_train/load_eval.
        if self.net is None or self.input_hw is None or self.input_c is None:
            from ..configs import PAPER_SPECS

            self._check_registered()
            meta = PAPER_SPECS.get(self.dataset)
            if meta is None:
                raise UnknownDatasetError(
                    f"dataset {self.dataset!r} has no paper-zoo defaults; "
                    "pass net, input_hw, and input_c explicitly")
            if self.net is None:
                object.__setattr__(self, "net", meta["spec"])
            if self.input_hw is None:
                object.__setattr__(self, "input_hw", meta["hw"])
            if self.input_c is None:
                object.__setattr__(self, "input_c", meta["c"])

        # net spec: compile_plan validates grammar + geometry (SpecError)
        engine.compile_plan(self.net, self.input_hw, self.input_c,
                            self.compressed)

        if self.backend not in engine.available_backends():
            raise UnknownBackendError(
                f"unknown backend {self.backend!r}; registered backends: "
                f"{sorted(engine.available_backends())}")
        try:
            neuron.get_neuron_model(self.mode)
        except ValueError as e:
            raise UnknownNeuronModeError(str(e)) from None
        if self.input_mode not in ("analog", "binary"):
            raise UnknownInputModeError(
                f"unknown input_mode {self.input_mode!r} "
                "(expected 'analog' or 'binary')")

        if self.training not in ("convert", "direct"):
            raise StudySpecError(
                f"unknown training {self.training!r} "
                "(expected 'convert' or 'direct')")
        try:
            neuron.get_surrogate(self.surrogate)
        except ValueError as e:
            raise StudySpecError(str(e)) from None
        from ..training.surrogate import VALID_TARGETS

        if self.loss_target not in VALID_TARGETS:
            raise StudySpecError(
                f"unknown loss_target {self.loss_target!r}; valid targets: "
                f"{VALID_TARGETS}")

        for name in ("n_train", "n_eval", "n_calib", "epochs", "train_batch",
                     "T", "depth", "batch", "n_balance", "snn_epochs",
                     "snn_batch"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise StudySpecError(
                    f"{name} must be a positive integer, got {v!r}")
        if self.weight_bits < 1 or self.train_weight_bits < 1:
            raise StudySpecError("bit widths must be >= 1")

    # -- convenience ------------------------------------------------------

    def replace(self, **changes) -> "StudySpec":
        """`dataclasses.replace` spelled as a method (sweep ergonomics)."""
        return dataclasses.replace(self, **changes)

    def snn_config(self):
        """The engine :class:`SNNConfig` this spec executes under.

        ``weight_bits`` reaches the engine only for the backends whose event
        path honors it (``queue_sparse``'s int-quantized accumulate and its
        ``queue_ref`` parity anchor); for every other backend it stays a
        pure pricing axis and the executed config keeps fp32 weights, so the
        collect cache is shared across the ``weight_bits`` sweep there.
        """
        from ..core.engine import SNNConfig

        return SNNConfig(
            spec=self.net, input_hw=self.input_hw, input_c=self.input_c,
            T=self.T, mode=self.mode, depth=self.depth,
            compressed=self.compressed, input_mode=self.input_mode,
            input_theta=self.input_theta, v_init_frac=self.v_init_frac,
            weight_bits=self.executed_weight_bits())

    def executed_weight_bits(self) -> int | None:
        """The weight width the engine will actually execute (None = fp32)."""
        return (self.weight_bits
                if self.backend in ("queue_sparse", "queue_ref") else None)

    def _check_registered(self):
        from ..data.synthetic import DATASETS

        if self.dataset not in DATASETS:
            raise UnknownDatasetError(
                f"unknown dataset {self.dataset!r}; registered datasets: "
                f"{sorted(DATASETS)}")

    def load_train(self):
        """(images, labels) for the train split — procedural, reproducible."""
        from ..data.synthetic import DATASETS

        self._check_registered()
        return DATASETS[self.dataset](self.n_train, seed=self.train_seed)

    def load_eval(self):
        from ..data.synthetic import DATASETS

        self._check_registered()
        return DATASETS[self.dataset](self.n_eval, seed=self.eval_seed)

    def pricing_label(self) -> str:
        """Human-readable tag for the price-stage fields (sweep tables)."""
        enc = "compressed" if self.compressed else "uncompressed"
        res = "VMEM" if self.vmem_resident else "HBM"
        return f"{enc}+{res}+w{self.weight_bits}"
