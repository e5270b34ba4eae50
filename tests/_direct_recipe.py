"""Does a direct-training recipe learn? Both packages, on the CPU.

For each init seed, trains the SNN with ``fit_snn`` three ways on the same
procedural CIFAR-like images and recipe (StudySpec's direct defaults: T 4,
``mttfs_cont``, analog input, batch 128, lr 5e-3, superspike beta 10,
target ``count``):

- the JAX package, from its own init (``jax.random.PRNGKey(seed)``);
- the port, from that same init (carried across with ``params_from_numpy``);
- the port, from its own init (``torch.Generator().manual_seed(seed)``);

and prints each run's final loss and its accuracy on 256 eval images
(``dense``). Spikes flip between the two packages' CPU convs on
non-dyadic inputs, so equal inits do not give equal nets after many steps:
compare the spread over seeds, not single runs. A narrow copy of the
paper's CIFAR-10 net keeps it to a few minutes:

    PYTHONPATH=src python tests/_direct_recipe.py --seeds 0,1,2,3
"""
import argparse
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.snn_model import init_params as jinit_params  # noqa: E402
from repro.training import surrogate as jsurrogate  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import snn_model as tmodel  # noqa: E402
from repro_torch.data.synthetic import make_cifar_like  # noqa: E402
from repro_torch.training import surrogate as tsurrogate  # noqa: E402

NARROW = "8C3-8C3-P3-16C3-16C3-P3-32C3-32C3-32C3-10"   # a quarter of Table 6


def _acc(pred, labels):
    return float((np.asarray(pred) == labels).mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default=NARROW)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args()

    images, labels = make_cifar_like(args.n_train, seed=0)
    ev, ev_labels = make_cifar_like(256, seed=1)
    recipe = dict(T=4, mode="mttfs_cont", epochs=args.epochs, batch=128,
                  lr=5e-3, beta=10.0)
    cfg_kw = dict(spec=args.net, input_hw=32, input_c=3, T=4,
                  mode="mttfs_cont")
    own_init = tsurrogate.init_params
    print(f"net {args.net}, {args.n_train} images x {args.epochs} epochs, "
          "batch 128: final loss / eval accuracy")
    for seed in (int(s) for s in args.seeds.split(",")):
        jp, jth, jl = jsurrogate.fit_snn(args.net, images, labels,
                                         init_seed=seed, **recipe)
        jlog, _ = jengine.infer_batch(jp, jth, jengine.SNNConfig(**cfg_kw),
                                      jnp.asarray(ev), backend="dense")
        ref_init = [{k: np.asarray(v) for k, v in p.items()}
                    for p in jinit_params(jax.random.PRNGKey(seed), args.net,
                                          32, 3)]
        row = [f"seed {seed}: reference {float(jl):.4f} / "
               f"{_acc(np.argmax(np.asarray(jlog), -1), ev_labels):.4f}"]
        for name, init in (("port, reference init",
                            lambda g, s, h, c, device=None:
                            tmodel.params_from_numpy(ref_init, [],
                                                     device=device)[0]),
                           ("port, own init", own_init)):
            tsurrogate.init_params = init
            tp, tth, tl = tsurrogate.fit_snn(args.net, images, labels,
                                             init_seed=seed, device="cpu",
                                             **recipe)
            tlog, _ = tengine.infer_batch(tp, tth, tengine.SNNConfig(**cfg_kw),
                                          ev, backend="dense", device="cpu")
            row.append(f"{name} {float(tl):.4f} / "
                       f"{_acc(tlog.argmax(-1).numpy(), ev_labels):.4f}")
        tsurrogate.init_params = own_init
        print("; ".join(row), flush=True)


if __name__ == "__main__":
    main()
