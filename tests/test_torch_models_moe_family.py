"""Whole-model parity of the port's LM stack on the MoE configuration
(shared and routed experts, dispatched through B6's plain version here)
(``tests/_smoke_archs.SMOKES``): ``forward``, ``prefill``, ``decode_step``,
``loss_fn``, its gradients and one ``make_train_step`` against the JAX
package's, from the reference's own initial weights carried across with
``params_from_numpy``, at the tolerances ``tests/_lm_parity.py`` states
(bf16 ulps of the largest magnitude; the gradients within 2^-5 of each
leaf's norm). Each configuration's outputs are computed once, in a
module-scoped fixture.
"""
import pytest

import _lm_parity as P

ARCHS = ('moe',)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return request.param, P.run_pair(request.param)


def test_forward_logits(pair):
    P.check_logits(pair[1]["forward"])


def test_prefill_and_decode(pair):
    P.check_logits(pair[1]["prefill"])
    P.check_caches(pair[1])
    P.check_logits(pair[1]["decode"])


def test_loss_lr_and_grad_norm(pair):
    P.check_loss(pair[1])


def test_gradients_and_one_train_step(pair):
    P.check_grads_and_step(pair[1])


def test_loss_against_the_scanned_reference(pair):
    P.check_scanned_loss(pair[0])
